#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feddrift_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines of output each:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA source of ``feddrift_torch/kernels/csrc``
   with nvcc (sm_90a) and prints the build seconds, ptxas' registers and
   spills per kernel, and the count of tensor-core (``HMMA``) instructions
   in the flash library's SASS (``cuobjdump``; "not measured" without it).
3. kernel: holds the flash-attention kernel against its plain PyTorch
   version on the card at the serving shape and the mean served
   micro-batch (q, k, v split off one qkv projection, as the transformer
   hands them over), and at three others, the last at L = 8192 for the
   error at long sequences; it times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it): per call, on the device, and the host's enqueue alone (host
   times in turns, five rounds, medians).
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
import os
import re
import shutil
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
# the kernel's route: TF32 tensor cores (495 TFLOP/s dense), three TF32
# products per float32 product to keep float32 accuracy
TC_3XTF32_FLOPS_PER_S = 495e12 / 3
NUM_REQUESTS = 512
CONCURRENCY = 8
SLICE_SHAPE = (32, 4, 80, 32)  # largest bucket x heads x seq x head dim
# (shape, causal, layout): "qkv" gives q, k, v as the transformer does,
# [B, H, L, D] views split off one [B, L, 3E] projection; "contiguous"
# gives three separate [B, H, L, D] tensors
SHAPES = ((SLICE_SHAPE, True, "qkv"),
          ((8, 4, 80, 32), True, "qkv"),  # the mean served micro-batch
          ((2, 2, 100, 8), False, "contiguous"),
          ((4, 8, 2048, 64), True, "contiguous"),
          ((1, 2, 8192, 64), True, "contiguous"))   # the error at long L


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


def _interleaved(measure, calls: dict, rounds: int = 5) -> dict:
    """``measure(fn)`` of each call, in turns for ``rounds`` rounds; the
    median of each. Host-side times drift within a run on a shared host,
    so the calls compared are measured side by side."""
    import statistics
    got = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            got[name].append(measure(fn))
    return {name: statistics.median(v) for name, v in got.items()}


def _host_enqueue_ms(fn, iters: int = 200) -> float:
    """Host time per call to enqueue ``fn``, without waiting for the card
    (the queue is drained before and after)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def _attention_bound_ms(shape, causal: bool,
                        flops_per_s: float) -> tuple[float, str]:
    """Least time for the function on the card: q, k, v read once and out
    written once over HBM, against the multiply-adds of the (q, k) pairs the
    mask keeps (q.k and p.v, 2 flops each per dim) at ``flops_per_s``."""
    B, H, L, D = shape
    pairs = L * (L + 1) // 2 if causal else L * L
    t_bytes = 4 * B * H * L * D * 4 / HBM_BYTES_PER_S
    t_ops = 4 * B * H * pairs * D / flops_per_s
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


def _ptxas_per_kernel(log: str) -> dict:
    """ptxas' registers and spills for each compiled kernel, keyed by the
    kernel's template arguments (``D=32``) or its name."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            t = re.search(r"ILi(\d+)E", m.group(1))
            name = f"D={t.group(1)}" if t else m.group(1)
        elif name and ("registers" in ln or "spill" in ln):
            out.setdefault(name, []).append(ln.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def _sass_count(lib_path: str, opcode: str):
    """Count of ``opcode`` instructions in a library's SASS, or "not
    measured" where the toolkit has no ``cuobjdump``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    if not os.path.isfile(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        return "not measured"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120)
    if sass.returncode != 0:
        return f"not measured (cuobjdump: {sass.stderr.strip()[:200]})"
    return sum(1 for ln in sass.stdout.splitlines()
               if re.search(rf"\b{opcode}\b", ln))


def phase_build() -> None:
    from feddrift_torch.kernels import build
    build.build_all()
    ptxas = {src: _ptxas_per_kernel(log)
             for src, log in sorted(build.build_log.items())}
    _say("build", seconds=round(build.build_seconds, 3),
         sources=sorted(build.build_log), ptxas=ptxas,
         flash_sass_hmma=_sass_count(build.lib_path("flash_attn_fwd.cu"),
                                     "HMMA"))


def phase_kernel() -> dict:
    import torch
    import torch.nn.functional as F
    from feddrift_torch.kernels.flash_attention import (flash_attention,
                                                        flash_attention_ref)
    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = None
    for shape, causal, layout in SHAPES:
        B, H, L, D = shape
        if layout == "qkv":
            qkv = torch.randn((B, L, 3 * H * D), generator=gen, device="cuda")
            q, k, v = (t.view(B, L, H, D).transpose(1, 2)
                       for t in qkv.split(H * D, dim=-1))
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                       for _ in range(3))
        out = flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        err = (out - flash_attention_ref(q, k, v, causal)).abs().max().item()
        calls = {
            "kernel": lambda: flash_attention(q, k, v, causal),
            "plain": lambda: flash_attention_ref(q, k, v, causal),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)}
        ms, plain_ms, library_ms = _interleaved(_time_ms, calls).values()
        device = {name: _device_ms(f) for name, f in calls.items()}
        # the host's floor: one PyTorch elementwise op on the same card
        enqueue = _interleaved(_host_enqueue_ms, {
            "kernel": calls["kernel"], "library": calls["library"],
            "one_op": lambda: torch.add(q, 1.0)})
        bound_ms, bound_by = _attention_bound_ms(shape, causal,
                                                 TC_3XTF32_FLOPS_PER_S)
        simt_ms, simt_by = _attention_bound_ms(shape, causal,
                                               F32_FLOPS_PER_S)
        device_vs_library = device["kernel"] / device["library"] \
            if device["kernel"] and device["library"] else "not measured"
        _say("kernel", name="flash_attn_fwd", shape=shape, causal=causal,
             layout=layout, max_abs_err=err, atol=KERNEL_ATOL, kernel_ms=ms,
             plain_ms=plain_ms, library_ms=library_ms,
             call_vs_library=ms / library_ms,
             device_vs_library=device_vs_library, bound_ms=bound_ms,
             bound_by=bound_by, bound_f32_simt_ms=simt_ms,
             bound_f32_simt_by=simt_by, kernel_device_ms=device["kernel"],
             plain_device_ms=device["plain"],
             library_device_ms=device["library"],
             kernel_enqueue_ms=enqueue["kernel"],
             library_enqueue_ms=enqueue["library"],
             one_op_enqueue_ms=enqueue["one_op"])
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
                     "device_ms": device["kernel"],
                     "bound_f32_simt_ms": simt_ms}
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
