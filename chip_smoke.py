#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feddrift_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines of output each:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA source of ``feddrift_torch/kernels/csrc``
   with nvcc (sm_90a) and prints the build seconds and ptxas' resource use.
3. kernel: holds the flash-attention kernel against its plain PyTorch
   version on the card at the serving shape and two others, and times the
   kernel, the plain version and ``F.scaled_dot_product_attention`` (a
   yardstick only; the port never calls it).
4. serve: the port's main path at full registry width. The ``shakespeare``
   dataset at its defaults, a pool of 4 distinct ``transformer`` models,
   10 clients spread over them, ``InferenceEngine`` with the
   (1, 2, 4, 8, 16, 32) buckets, 512 requests from 8 closed-loop workers
   with dataset windows as inputs. Fails unless every request completed
   with no error and the kernel was launched on that path; then checks
   served answers against one-row forwards and against the plain CPU path.

It then prints the kernels' JSON line, the card line and, last, the result
line. Any failed phase exits non-zero before the result line. It imports
nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback

# |kernel - plain| bound: float32 with the sums in another order; outputs
# are convex combinations of v rows (|v| ~ 4 at most), ~1e-6 rounding
KERNEL_ATOL = 1e-5
# served logits against the plain CPU path (blockwise attention, CPU
# matmuls): two 128-wide layers summed in other orders, as the CPU tests
SERVE_ATOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
NUM_REQUESTS = 512
CONCURRENCY = 8
SLICE_SHAPE = (32, 4, 80, 32)  # largest bucket x heads x seq x head dim
SHAPES = ((SLICE_SHAPE, True), ((2, 2, 100, 8), False),
          ((4, 8, 2048, 64), True))


def _say(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=str), flush=True)


def _time_ms(fn, iters: int = 50) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, reps: int):
    """Run ``fn`` ``reps`` times under torch.profiler; returns the CUDA
    kernels it launched (FunctionEventAvg, device time > 0) and the wall
    microseconds of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    return kernels, wall_us


def _device_ms(fn, reps: int = 20):
    """Device time per call of ``fn``: the summed duration of the CUDA
    kernels it launches, free of host launch gaps. None when the profiler
    records no device time."""
    kernels, _ = _profile(fn, reps)
    busy_us = sum(e.self_device_time_total for e in kernels)
    return busy_us / reps / 1e3 if busy_us > 0 else None


def _attention_bound_ms(shape, causal: bool) -> tuple[float, str]:
    """Least time for the function on the card: q, k, v read once and out
    written once over HBM, against the multiply-adds of the (q, k) pairs the
    mask keeps (q.k and p.v, 2 flops each per dim) at the f32 peak."""
    B, H, L, D = shape
    pairs = L * (L + 1) // 2 if causal else L * L
    t_bytes = 4 * B * H * L * D * 4 / HBM_BYTES_PER_S
    t_ops = 4 * B * H * pairs * D / F32_FLOPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def phase_device() -> str:
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False    # Dense bmm stays f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    _say("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, allow_tf32=False, nvidia_smi=card)
    return card


def phase_build() -> None:
    from feddrift_torch.kernels import build
    build.build_all()
    ptxas = [ln.strip() for log in build.build_log.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    _say("build", seconds=round(build.build_seconds, 3),
         sources=sorted(build.build_log), ptxas=ptxas)


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from feddrift_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = None
    for shape, causal in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(3))
        out = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        err = (out - flash_attention_ref(q, k, v, causal)).abs().max().item()
        ms = _time_ms(lambda: flash_attention(q, k, v, causal))
        plain_ms = _time_ms(lambda: flash_attention_ref(q, k, v, causal))
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        device = {name: _device_ms(f) for name, f in (
            ("kernel", lambda: flash_attention(q, k, v, causal)),
            ("plain", lambda: flash_attention_ref(q, k, v, causal)),
            ("library", lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)))}
        bound_ms, bound_by = _attention_bound_ms(shape, causal)
        _say("kernel", name="flash_attn_fwd", shape=shape, causal=causal,
             max_abs_err=err, atol=KERNEL_ATOL, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
             bound_by=bound_by, kernel_device_ms=device["kernel"],
             plain_device_ms=device["plain"],
             library_device_ms=device["library"])
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"flash_attn_fwd at {shape} causal={causal}: "
                                 f"max |kernel - plain| {err} > {KERNEL_ATOL}")
        if shape == SLICE_SHAPE:
            entry = {"name": "flash_attn_fwd", "route": "cuda",
                     "source": "feddrift_torch/kernels/csrc/flash_attn_fwd.cu",
                     "replaces": "feddrift_tpu/parallel/pallas_attention.py:111",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     "device_ms": device["kernel"]}
    return entry


def phase_serve(entry: dict) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.core.pool import ModelPool
    from feddrift_torch.data.registry import make_dataset
    from feddrift_torch.kernels.flash_attention import flash_attention
    from feddrift_torch.models import create_model
    from feddrift_torch.models.transformer import TransformerLM
    from feddrift_torch.platform.serving import (SERVE_BUCKETS,
                                                 InferenceEngine,
                                                 RoutingTable,
                                                 TrafficGenerator)

    cfg = ExperimentConfig(dataset="shakespeare", model="transformer")
    t0 = time.perf_counter()
    ds = make_dataset(cfg)
    data_s = time.perf_counter() - t0
    model = create_model(cfg.model, ds, cfg)
    pool = ModelPool.create(model, torch.from_numpy(ds.x[0, 0, :2]),
                            cfg.num_models, seed=cfg.seed, identical=False,
                            device="cuda")
    assignment = np.arange(cfg.client_num_in_total) % cfg.num_models
    engine = InferenceEngine(pool, RoutingTable.from_assignment(assignment),
                             buckets=SERVE_BUCKETS)
    windows = ds.x.reshape(-1, ds.x.shape[-1])
    try:
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        engine.start()
        batches0 = engine.stats()["batches"]

        flash_attention.launches = 0
        traffic = TrafficGenerator(
            engine, range(cfg.client_num_in_total), seed=cfg.seed,
            concurrency=CONCURRENCY,
            make_x=lambda rng: windows[rng.randint(len(windows))]
        ).run(NUM_REQUESTS)
        launches = flash_attention.launches

        stats = engine.stats()
        batches = stats["batches"] - batches0
        _say("serve", dataset=cfg.dataset, x_shape=ds.x.shape,
             data_s=data_s, model=cfg.model, d_model=model.d_model,
             heads=model.num_heads, layers=len(model.blocks),
             vocab=model.vocab_size, pool=cfg.num_models,
             warmup_s=warmup_s, flash_launches=launches,
             micro_batches=batches,
             mean_batch=stats["served"] / max(stats["batches"], 1),
             **traffic, engine=stats)
        entry["launches"] = launches
        if traffic["errors"] or traffic["completed"] != NUM_REQUESTS:
            raise AssertionError(f"serving failed: {traffic}")
        if launches <= 0 or launches != len(model.blocks) * batches:
            raise AssertionError(f"flash launches {launches} for {batches} "
                                 f"micro-batches of {len(model.blocks)} layers")

        # served answers, coalesced into mixed-model micro-batches, against
        # one-row forwards of the same request and against the plain path
        rng = np.random.RandomState(1)
        clients = rng.randint(cfg.client_num_in_total, size=48)
        xs = windows[rng.randint(len(windows), size=48)]
        with ThreadPoolExecutor(max_workers=48) as ex:
            results = list(ex.map(engine.submit, clients, xs))
        gen = engine._gen
        rows = []
        for r, x in zip(results, xs):
            one = engine.step.forward(
                gen.params, torch.from_numpy(x[None]).cuda(),
                torch.tensor([r.model], device="cuda"))
            rows.append(one[0].cpu().numpy())
        rows = np.stack(rows)
        served = np.stack([r.logits for r in results])
        one_row_err = float(np.abs(served - rows).max())
        cpu_model = TransformerLM(
            vocab_size=model.vocab_size, d_model=model.d_model,
            num_heads=model.num_heads, num_layers=len(model.blocks),
            max_len=model.max_len, attention_impl="blockwise")
        cpu_params = {k: p.cpu() for k, p in gen.params.items()}
        with torch.no_grad():
            plain = cpu_model(
                {k: p[torch.tensor([r.model for r in results])]
                 for k, p in cpu_params.items()}, torch.from_numpy(xs)
            ).numpy()
        plain_err = float(np.abs(served - plain).max())
        _say("serve_check", requests=len(results),
             models=sorted({r.model for r in results}),
             finite=bool(np.isfinite(served).all()),
             one_row_bitwise=bool(np.array_equal(served, rows)),
             one_row_max_abs_err=one_row_err,
             plain_cpu_max_abs_err=plain_err, atol=SERVE_ATOL)
        if not (np.isfinite(served).all() and served.shape == (48, 90)):
            raise AssertionError("served logits not finite [48, 90]")
        if not (one_row_err <= KERNEL_ATOL and plain_err <= SERVE_ATOL):
            raise AssertionError("served answers disagree with the one-row "
                                 "forward or the plain CPU path")

        # device time of one micro-batch forward per bucket (CUDA events)
        fwd = {}
        for b in SERVE_BUCKETS:
            x = torch.from_numpy(windows[:b].copy()).cuda()
            midx = torch.arange(b, device="cuda") % cfg.num_models
            fwd[b] = _time_ms(lambda: engine.step.forward(gen.params, x,
                                                          midx), iters=20)
        _say("serve_forward_ms", **{f"b{b}": t for b, t in fwd.items()})
        _profile_forward(engine.step, gen.params, x, midx)
    finally:
        engine.close()


def _profile_forward(step, params, x, midx, reps: int = 10) -> None:
    """Where one micro-batch forward's time goes: the device-busy share of
    its wall time (profiler on) and the kernels that take it."""
    kernels, wall_us = _profile(lambda: step.forward(params, x, midx), reps)
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    _say("serve_profile", batch=x.shape[0],
         wall_ms_per_forward=wall_us / reps / 1e3,
         device_busy_ms_per_forward=busy_us / reps / 1e3,
         device_busy_share=busy_us / wall_us if busy_us else "not measured",
         kernel_launches_per_forward=sum(e.count for e in kernels) / reps,
         top_kernels_us_per_forward={
             e.key[:60]: e.self_device_time_total / reps for e in top})


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    try:
        import feddrift_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository "
              "(feddrift_torch not found)", file=sys.stderr)
        return 1
    try:
        card = phase_device()
        phase_build()
        entry = phase_kernel()
        phase_serve(entry)
    except Exception:   # noqa: BLE001 — report the phase that failed
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
