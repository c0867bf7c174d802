"""Versioned single-checkpoint store: model pool + algorithm state + cursor.

Counterpart of ``feddrift_tpu/utils/checkpoint.py`` in a torch format. One
directory per experiment holds everything an iteration-granular resume
needs:

    ckpt/
      MANIFEST.json     {version, iteration, global_round, config, checksums}
      pool.pt           the [M]-stacked parameter dict (torch.save, CPU)
      algo.pkl          the algorithm's state_dict (numpy, pickled)

Writes are atomic (a temporary directory, then ``os.replace``) and every
payload's sha256 is in the manifest, so ``load_checkpoint`` detects a
truncated or corrupt file before deserialising it. The previous complete
generation stays at ``<path>.old``: a corrupt primary falls back to it with a
``checkpoint_corrupt`` event; only when no generation loads does loading
raise.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
import tempfile
from typing import Any

import torch

from feddrift_torch import obs

log = logging.getLogger("feddrift_torch")

CKPT_VERSION = 1
_PAYLOAD_FILES = ("pool.pt", "algo.pkl")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint generation failed verification or deserialization."""


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def save_checkpoint(path: str, *, config_json: str, iteration: int,
                    global_round: int, pool_params: dict[str, torch.Tensor],
                    algo_state: dict) -> None:
    """Atomically write a complete checkpoint to ``path``; the previous
    generation survives at ``path + '.old'``."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=parent)
    try:
        torch.save({k: v.detach().cpu().contiguous().clone()
                    for k, v in pool_params.items()},
                   os.path.join(tmp, "pool.pt"))
        with open(os.path.join(tmp, "algo.pkl"), "wb") as f:
            pickle.dump(algo_state, f)
        checksums = {name: _sha256(os.path.join(tmp, name))
                     for name in _PAYLOAD_FILES}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"version": CKPT_VERSION, "iteration": iteration,
                       "global_round": global_round, "checksums": checksums,
                       "config": json.loads(config_json)}, f, indent=2)
        old = path + ".old"
        if os.path.isdir(path):
            if os.path.isdir(old):
                shutil.rmtree(old)
            os.replace(path, old)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def verify_checkpoint(path: str) -> dict:
    """Read and verify one generation's manifest; returns it. Raises
    ``CheckpointCorruptError`` on an unreadable manifest, a missing payload
    or a sha256 mismatch."""
    manifest_path = os.path.join(path, "MANIFEST.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
        raise CheckpointCorruptError(
            f"unreadable manifest {manifest_path}: {exc}") from exc
    for name, want in manifest.get("checksums", {}).items():
        fpath = os.path.join(path, name)
        if not os.path.isfile(fpath):
            raise CheckpointCorruptError(f"missing payload file {fpath}")
        got = _sha256(fpath)
        if got != want:
            raise CheckpointCorruptError(
                f"sha256 mismatch for {fpath}: manifest {want[:12]}..., "
                f"file {got[:12]}... (truncated or corrupted write)")
    return manifest


def _load_generation(path: str, device: str | torch.device) -> dict:
    manifest = verify_checkpoint(path)
    if manifest["version"] != CKPT_VERSION:
        raise ValueError(
            f"checkpoint version {manifest['version']} != {CKPT_VERSION}")
    try:
        pool = torch.load(os.path.join(path, "pool.pt"), map_location=device,
                          weights_only=True)
        with open(os.path.join(path, "algo.pkl"), "rb") as f:
            algo_state = pickle.load(f)
    except (ValueError, RuntimeError, pickle.UnpicklingError, EOFError) as exc:
        raise CheckpointCorruptError(
            f"deserialization failed in {path}: {exc}") from exc
    return {"iteration": int(manifest["iteration"]),
            "global_round": int(manifest["global_round"]),
            "config": manifest["config"], "pool_params": pool,
            "algo_state": algo_state}


def load_checkpoint(path: str, device: str | torch.device = "cuda") -> dict:
    """The newest loadable generation: the primary, then ``<path>.old``.
    A generation that fails verification emits ``checkpoint_corrupt`` and
    falls through; only when none loads does this raise."""
    errors: list[str] = []
    for gen in (path, path + ".old"):
        if not os.path.isdir(gen):
            continue
        try:
            return _load_generation(gen, device)
        except CheckpointCorruptError as exc:
            log.error("checkpoint generation %s is corrupt: %s "
                      "(falling back)", gen, exc)
            obs.emit("checkpoint_corrupt", path=gen, reason=str(exc))
            obs.registry().counter("checkpoint_corruptions").inc()
            errors.append(f"{gen}: {exc}")
    if errors:
        raise CheckpointCorruptError(
            "no loadable checkpoint generation; rejected: " + "; ".join(errors))
    raise FileNotFoundError(f"no checkpoint at {path} (or {path}.old)")
