"""Change-point matrices: concept id per (time step, client).

A change-point matrix is a ``[T_cp, C]`` integer array; entry ``(t, c)`` is the
concept generating client ``c``'s data during time step ``t`` (reference:
data/changepoints/*.cp, consumed by ``generate_data_sea`` at
fedml_api/data_preprocessing/sea/data_loader.py:66-73).

The published presets A-F, R0-R9, W-Z (the benchmark definitions from the
FedDrift paper; 11x10 each) are shipped as data files under
``feddrift_torch/data/changepoints/`` (copies of the reference package's
files). Random generation reproduces the
reference's ``rand`` semantics (sea/data_loader.py:48-64): one change point per
client, drawn uniformly from [1, T/stretch), optionally shared by all clients
(``drift_together``).
"""

from __future__ import annotations

import os

import numpy as np

_PRESET_DIR = os.path.join(os.path.dirname(__file__), "changepoints")


def available_presets() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(_PRESET_DIR) if f.endswith(".cp"))


def load_change_points(name: str) -> np.ndarray:
    """Load a preset matrix by name (e.g. 'A'), or parse a whitespace matrix."""
    path = os.path.join(_PRESET_DIR, f"{name}.cp")
    if os.path.exists(path):
        return np.loadtxt(path, dtype=np.int32, ndmin=2)
    # Allow passing a literal matrix string ("0 0;1 0;..." or newline separated)
    if any(ch in name for ch in " ;\n"):
        rows = [r for r in name.replace(";", "\n").splitlines() if r.strip()]
        return np.asarray([[int(v) for v in r.split()] for r in rows], dtype=np.int32)
    raise FileNotFoundError(f"unknown change-point preset {name!r}; "
                            f"available: {available_presets()}")


def generate_random_change_points(
    train_iterations: int,
    num_clients: int,
    drift_together: int = 0,
    time_stretch: int = 1,
    seed: int | np.random.Generator = 0,
) -> np.ndarray:
    """Single-drift random matrix, reference semantics (sea/data_loader.py:48-64).

    Each client flips from concept 0 to concept 1 at a change point drawn
    uniformly from [1, T//stretch); with ``drift_together`` all clients share
    one change point. Matrix has T//stretch + 1 rows (so index t//stretch is
    valid for t = train_iterations, the held-out test step).
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    t_rows = train_iterations // time_stretch
    if t_rows < 2:
        raise ValueError("train_iterations//time_stretch must be >= 2 for a drift")
    if drift_together:
        cp = int(rng.integers(1, t_rows))
        change_point_per_client = [cp] * num_clients
    else:
        change_point_per_client = [int(rng.integers(1, t_rows)) for _ in range(num_clients)]
    mat = np.zeros((t_rows + 1, num_clients), dtype=np.int32)
    for c, t in enumerate(change_point_per_client):
        mat[t:, c] = 1
    return mat


def concept_matrix(change_points: np.ndarray, num_steps: int, num_clients: int,
                   time_stretch: int = 1) -> np.ndarray:
    """Dense ``[num_steps, C]`` concept-id matrix for steps 0..num_steps-1."""
    out = np.zeros((num_steps, num_clients), dtype=np.int32)
    for t in range(num_steps):
        row = min(t // time_stretch, change_points.shape[0] - 1)
        out[t] = change_points[row, :num_clients]
    return out
