#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``feddrift_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one or more lines of output each:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every CUDA source of ``feddrift_torch/kernels/csrc``
   with nvcc (sm_90a, one process a source, all at once) and prints the
   build seconds, ptxas' registers and spills per kernel of every source,
   and the count of tensor-core (``HMMA``) instructions in the flash and
   ``dense_rows`` libraries' SASS (``cuobjdump``; "not measured" without
   it).
3. kernel: holds the flash-attention kernel against its plain PyTorch
   version on the card at the serving shape and the mean served
   micro-batch (q, k, v split off one qkv projection, as the transformer
   hands them over), and at three others, the last at L = 8192 for the
   error at long sequences; it times the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it): per call, on the device, and the host's enqueue alone (host
   times in turns, five rounds, medians). Then the per-row Dense kernel
   (``dense_rows``) at the five Dense shapes of the served transformer at
   b32 and b8: against its plain version (and both against the float64
   product), its first and last rows bitwise equal to their b1 calls, and
   its times (with its route) beside ``torch.bmm``'s (``torch.baddbmm``
   where the layer has a bias), the device time recorded for its first
   design (SIMT float32) and the bound (over the routes the card offers:
   bytes against 3xTF32 tensor-core operations, the float32 SIMT figure
   beside it); then the Dense work of one forward (``dense_forward``: 2 x
   the four block layers + the lm_head) at each batch.
4. serve: the port's main path at full registry width. The ``shakespeare``
   dataset at its defaults, a pool of 4 distinct ``transformer`` models,
   10 clients spread over them, ``InferenceEngine`` with the
   (1, 2, 4, 8, 16, 32) buckets, 512 requests from 8 closed-loop workers
   with dataset windows as inputs. Fails unless every request completed
   with no error and both kernels were launched on that path (2 flash and
   9 Dense launches a micro-batch); then checks served answers against
   one-row forwards (bitwise) and against the plain CPU path, and runs one
   row alone and in a batch of 32, op by op: it fails if any op's answer
   for that row depends on the batch.
5. train_kernel: holds K1, the local-SGD kernel, against its plain version
   on the card through both of its kernels: the fused one at the canonical
   SEA shape (M=4 models, C=10 clients, T1=11 steps, N=B=500 rows, S=5
   local steps, 3->10->2 fnn) with three pairs and one whole model
   inactive and at F=2 (sine), the general one at the SEA shape (forced:
   the kernel of the first design, timed in the same run) and at H=32;
   two calls of each must agree bitwise. It times each (per call and on
   the device, and the device time per local step) and the plain version
   in turns; then times the round's two other device steps, still plain
   PyTorch (the masked FedAvg and the eval matrices), against their
   bounds.
6. train: the port's training main path at full width, the canonical
   ``python -m feddrift_torch run`` configuration (SEA, change points A,
   fnn, softcluster H_A_C_1_10_0, 10 steps x 200 rounds, checkpoint every
   step): per-step wall, rounds/s, final Test/Acc and models in use, then
   K1's launches (through the fused kernel) and the device-busy share of
   one profiled time step.
   Fails unless every step ran, the checkpoint exists, K1 carried all
   2000 rounds and Test/Acc tracks the committed reference run
   ``runs/sea-fnn-softcluster-H_A_C_1_10_0-s0`` (each step within 0.04,
   the 10-step mean within 0.015: across seeds 0-2 of the committed
   ``H_A_F_1_3_0`` runs one step differs by up to 0.025, the mean by 0.003).

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
# the kernels' route: TF32 tensor cores (495 TFLOP/s dense), three TF32
# products per float32 product to keep float32 accuracy
TC_3XTF32_FLOPS_PER_S = 495e12 / 3
# |K1 - plain| on params, mu and losses: float32 gradient sums over 500
# rows in another order, five AMSGrad steps of lr = 0.01; nu and nu_max
# (squares of gradients) at a relative 1e-4
TRAIN_ATOL = 1e-5
TRAIN_NU_RTOL = 1e-4
REF_RUN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "runs",
                       "sea-fnn-softcluster-H_A_C_1_10_0-s0", "metrics.jsonl")
# that run's final Test/Acc per step, as committed
REF_ACCS = (0.859, 0.8566, 0.8718, 0.8478, 0.8548, 0.8702, 0.8646, 0.87,
            0.8632, 0.8626)
STEP_ACC_TOL = 0.04
MEAN_ACC_TOL = 0.015
NUM_REQUESTS = 512
CONCURRENCY = 8
# K1's device time at the canonical shape as recorded for its first design
# (PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W), printed beside
# this run's
K1_FIRST_DESIGN_DEVICE_MS = 0.08191
SLICE_SHAPE = (32, 4, 80, 32)  # largest bucket x heads x seq x head dim
# (shape, causal, layout): "qkv" gives q, k, v as the transformer does,
# [B, H, L, D] views split off one [B, L, 3E] projection; "contiguous"
# gives three separate [B, H, L, D] tensors
SHAPES = ((SLICE_SHAPE, True, "qkv"),
          ((8, 4, 80, 32), True, "qkv"),  # the mean served micro-batch
          ((2, 2, 100, 8), False, "contiguous"),
          ((4, 8, 2048, 64), True, "contiguous"),
          ((1, 2, 8192, 64), True, "contiguous"))   # the error at long L
# the served transformer's Dense layers: (layer, L, in, out, bias); the
# lm_head sees the last position only
DENSE_SHAPES = (("qkv", 80, 128, 384, False), ("proj", 80, 128, 128, False),
                ("Dense_0", 80, 128, 512, True),
                ("Dense_1", 80, 512, 128, True),
                ("lm_head", 1, 128, 90, True))
DENSE_BATCHES = (32, 8)        # the largest bucket and the mean micro-batch
DENSE_ENTRY = ("Dense_0", 32)  # the kernels line's representative call
# launches of each Dense layer in one forward of the 2-block transformer
DENSE_PER_FORWARD = {"qkv": 2, "proj": 2, "Dense_0": 2, "Dense_1": 2,
                     "lm_head": 1}
# dense_rows's device ms per layer and batch as recorded for its first
# design (SIMT float32; PERF.md's kernel table, NVIDIA H100 80GB HBM3,
# 700 W), printed beside this run's as pr4_device_ms
DENSE_FIRST_DESIGN_DEVICE_MS = {
    32: {"qkv": 0.02168, "proj": 0.01561, "Dense_0": 0.02700,
         "Dense_1": 0.05562, "lm_head": 0.01023},
    8: {"qkv": 0.01372, "proj": 0.01344, "Dense_0": 0.01614,
        "Dense_1": 0.04987, "lm_head": 0.00997}}


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
    kernel's name and its int and bool template arguments
    (``flash_fwd_kernel<32>``, ``dense_rows_mma_kernel<64,1>``)."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?",
                          m.group(1))
            ints = re.findall(r"L[ib](\d+)E", k.group(2) or "") if k else []
            name = (k.group(1) + (f"<{','.join(ints)}>" if ints else "")) \
                if k else m.group(1)
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
                                     "HMMA"),
         dense_sass_hmma=_sass_count(build.lib_path("dense_rows.cu"),
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


def _dense_bound_ms(B: int, L: int, n_in: int, n_out: int, bias: bool,
                    flops_per_s: float = TC_3XTF32_FLOPS_PER_S
                    ) -> tuple[float, str]:
    """Least time for one per-row Dense on the card: x, the per-row weights
    (and bias) read once and y written once over HBM, against its
    multiply-adds (and bias adds) at ``flops_per_s``. The default is the
    fastest float32-accurate route the card offers, 3xTF32 on the tensor
    cores; ``F32_FLOPS_PER_S`` gives the SIMT figure."""
    nbytes = 4 * (B * L * n_in + B * n_in * n_out + B * L * n_out
                  + (B * n_out if bias else 0))
    flops = 2 * B * L * n_in * n_out + (B * L * n_out if bias else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


def phase_dense() -> dict:
    """The per-row Dense kernel at the served transformer's Dense shapes:
    error against its plain version, its first and last rows bitwise equal
    to their b1 calls, and its times beside torch.bmm's (baddbmm's with a
    bias), its first design's recorded time and the bound; then the Dense
    work of one forward at each batch."""
    import torch
    from feddrift_torch.kernels.dense_rows import (_launch_config,
                                                   dense_rows, dense_rows_ref)
    gen = torch.Generator(device="cuda").manual_seed(1)
    entry = None
    for B in DENSE_BATCHES:
        forward = {"kernel": 0.0, "library": 0.0, "first": 0.0,
                   "bound": 0.0, "simt": 0.0}
        for layer, L, n_in, n_out, has_bias in DENSE_SHAPES:
            x = torch.randn((B, L, n_in), generator=gen, device="cuda")
            w = torch.randn((B, n_in, n_out), generator=gen,
                            device="cuda") / n_in ** 0.5
            b = torch.randn((B, n_out), generator=gen, device="cuda") * 0.1 \
                if has_bias else None
            out = dense_rows(x, w, b)
            ones = [dense_rows(x[r:r + 1], w[r:r + 1],
                               None if b is None else b[r:r + 1])
                    for r in (0, B - 1)]
            torch.cuda.synchronize()
            plain = dense_rows_ref(x, w, b)
            err = (out - plain).abs().max().item()
            # both against the exact product (float64): the kernel's own
            # error apart from the plain version's rounding
            exact = dense_rows_ref(x.double(), w.double(),
                                   None if b is None else b.double())
            err64 = (out - exact).abs().max().item()
            plain_err64 = (plain - exact).abs().max().item()
            row_bitwise = bool(torch.equal(ones[0][0], out[0])
                               and torch.equal(ones[1][0], out[B - 1]))
            library = (lambda: torch.baddbmm(b[:, None, :], x, w)) \
                if has_bias else (lambda: torch.bmm(x, w))
            calls = {"kernel": lambda: dense_rows(x, w, b),
                     "plain": lambda: dense_rows_ref(x, w, b),
                     "library": library}
            ms, plain_ms, library_ms = _interleaved(_time_ms, calls).values()
            device = {name: _device_ms(f) for name, f in calls.items()}
            enqueue = _interleaved(_host_enqueue_ms, {
                "kernel": calls["kernel"], "library": library})
            bound_ms, bound_by = _dense_bound_ms(B, L, n_in, n_out, has_bias)
            simt_ms, simt_by = _dense_bound_ms(B, L, n_in, n_out, has_bias,
                                               F32_FLOPS_PER_S)
            first_ms = DENSE_FIRST_DESIGN_DEVICE_MS[B][layer]
            cfg = _launch_config(L, n_in, n_out)
            _say("kernel", name="dense_rows", layer=layer,
                 shape=(B, L, n_in, n_out), bias=has_bias, route=cfg.route,
                 tile=(cfg.tile_l, cfg.tile_out), warps=cfg.warps,
                 max_abs_err=err, atol=KERNEL_ATOL,
                 max_abs_err_vs_f64=err64,
                 plain_max_abs_err_vs_f64=plain_err64,
                 row_bitwise=row_bitwise,
                 kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 library="torch.baddbmm" if has_bias else "torch.bmm",
                 kernel_device_ms=device["kernel"],
                 plain_device_ms=device["plain"],
                 library_device_ms=device["library"],
                 device_vs_library=device["kernel"] / device["library"]
                 if device["kernel"] and device["library"]
                 else "not measured",
                 pr4_device_ms=first_ms,
                 kernel_enqueue_ms=enqueue["kernel"],
                 library_enqueue_ms=enqueue["library"], bound_ms=bound_ms,
                 bound_by=bound_by, bound_f32_simt_ms=simt_ms,
                 bound_f32_simt_by=simt_by,
                 device_vs_bound=(device["kernel"] or ms) / bound_ms)
            if not (err <= KERNEL_ATOL and row_bitwise):
                raise AssertionError(f"dense_rows {layer} at b{B}: max "
                                     f"|kernel - plain| {err} (atol "
                                     f"{KERNEL_ATOL}), row bitwise "
                                     f"{row_bitwise}")
            n = DENSE_PER_FORWARD[layer]
            forward["kernel"] += n * (device["kernel"] or float("nan"))
            forward["library"] += n * (device["library"] or float("nan"))
            forward["first"] += n * first_ms
            forward["bound"] += n * bound_ms
            forward["simt"] += n * simt_ms
            if (layer, B) == DENSE_ENTRY:
                entry = {"name": "dense_rows", "route": "cuda",
                         "source": "feddrift_torch/kernels/csrc/dense_rows.cu",
                         "replaces": "feddrift_tpu/models/transformer.py:77",
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms,
                         "device_ms": device["kernel"],
                         "bound_f32_simt_ms": simt_ms,
                         "shape": (B, L, n_in, n_out)}
        _say("dense_forward", batch=B,
             launches=sum(DENSE_PER_FORWARD.values()),
             kernel_device_ms=forward["kernel"],
             library_device_ms=forward["library"],
             pr4_device_ms=forward["first"], bound_ms=forward["bound"],
             bound_f32_simt_ms=forward["simt"],
             device_vs_library=forward["kernel"] / forward["library"],
             device_vs_bound=forward["kernel"] / forward["bound"])
    return entry


def phase_serve(entry: dict, dense_entry: dict) -> None:
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.core.pool import ModelPool
    from feddrift_torch.data.registry import make_dataset
    from feddrift_torch.kernels.dense_rows import dense_rows
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
        dense_rows.launches = 0
        traffic = TrafficGenerator(
            engine, range(cfg.client_num_in_total), seed=cfg.seed,
            concurrency=CONCURRENCY,
            make_x=lambda rng: windows[rng.randint(len(windows))]
        ).run(NUM_REQUESTS)
        launches = flash_attention.launches
        dense_launches = dense_rows.launches

        stats = engine.stats()
        batches = stats["batches"] - batches0
        layers = len(model.blocks)
        _say("serve", dataset=cfg.dataset, x_shape=ds.x.shape,
             data_s=data_s, model=cfg.model, d_model=model.d_model,
             heads=model.num_heads, layers=layers,
             vocab=model.vocab_size, pool=cfg.num_models,
             warmup_s=warmup_s, flash_launches=launches,
             dense_rows_launches=dense_launches, micro_batches=batches,
             mean_batch=stats["served"] / max(stats["batches"], 1),
             **traffic, engine=stats)
        entry["launches"] = launches
        dense_entry["launches"] = dense_launches
        if traffic["errors"] or traffic["completed"] != NUM_REQUESTS:
            raise AssertionError(f"serving failed: {traffic}")
        if launches <= 0 or launches != layers * batches:
            raise AssertionError(f"flash launches {launches} for {batches} "
                                 f"micro-batches of {layers} layers")
        # four Dense layers a block and the lm_head
        if dense_launches <= 0 or dense_launches != (4 * layers + 1) * batches:
            raise AssertionError(f"dense_rows launches {dense_launches} for "
                                 f"{batches} micro-batches of {layers} "
                                 f"layers")

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
        one_row_bitwise = bool(np.array_equal(served, rows))
        _say("serve_check", requests=len(results),
             models=sorted({r.model for r in results}),
             finite=bool(np.isfinite(served).all()),
             one_row_bitwise=one_row_bitwise,
             one_row_max_abs_err=one_row_err,
             plain_cpu_max_abs_err=plain_err, atol=SERVE_ATOL)
        if not (np.isfinite(served).all() and served.shape == (48, 90)):
            raise AssertionError("served logits not finite [48, 90]")
        if not (one_row_bitwise and plain_err <= SERVE_ATOL):
            raise AssertionError("served answers differ from the one-row "
                                 "forward (bitwise) or the plain CPU path")

        first = _batch_variance(engine.step, gen.params, windows,
                                cfg.num_models)
        if first is not None:
            raise AssertionError(f"row 0's answer depends on its batch from "
                                 f"op {first} on")

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


def _batch_variance(step, params, windows, num_models: int):
    """One serving forward of the same row alone (b1) and first in a batch
    of 32, every op's output recorded: the max difference of that row per
    op, and the first op whose row differs bitwise (returned; None when
    every op agrees)."""
    import torch
    from feddrift_torch.models import transformer
    from feddrift_torch.obs.optrace import first_difference, record_calls
    x = torch.from_numpy(windows[:32].copy()).cuda()
    midx = torch.arange(32, device="cuda") % num_models
    ops = ("embed", "layer_norm", "dense", "flash_attention")
    with record_calls(transformer, ops) as one:
        step.forward(params, x[:1], midx[:1])
    with record_calls(transformer, ops) as many:
        step.forward(params, x, midx)
    torch.cuda.synchronize()
    diffs, first = first_difference(one, many)
    _say("serve_check", what="batch_variance", row=0, batches=(1, 32),
         first_op_that_differs=first, max_abs_diff_per_op=dict(diffs))
    return first


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


def _train_case(dataset: str, seed: int, hidden: int = 10):
    """One canonical round's K1 inputs on the card: the dataset at its
    registry defaults (the fnn's hidden width ``hidden``), a pool of 4
    distinct fnn draws, fresh optimizer state, seeded time weights with
    pairs (0, 3), (2, 7) and all of model 3 inactive, and seeded batch
    indices."""
    import numpy as np
    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.data.registry import make_dataset
    from feddrift_torch.kernels.local_sgd import init_opt_state
    from feddrift_torch.models import create_model
    cfg = ExperimentConfig(dataset=dataset,
                           change_points="A" if dataset == "sea" else "W",
                           fnn_hidden_dim=hidden)
    ds = make_dataset(cfg)
    mod = create_model("fnn", ds, cfg)
    gen = torch.Generator().manual_seed(seed)
    M, (C, T1, N, F) = cfg.num_models, ds.x.shape
    params = torch.stack([mod.pack(mod.init_params(gen, "cuda"))
                          for _ in range(M)])
    rng = np.random.default_rng(seed)
    tw = (rng.random((M, C, T1)) < 0.5).astype(np.float32)
    tw[:, :, -1] = 0
    tw[0, 3] = tw[2, 7] = tw[3] = 0
    S, B = cfg.epochs, min(cfg.batch_size, N)
    t_idx = rng.integers(0, T1 - 1, (M, C, S)).astype(np.int32)
    slot = rng.integers(0, N // B, (M, C, S)).astype(np.int32)
    dev = lambda a: torch.from_numpy(a).cuda()
    args = (dev(ds.x), dev(ds.y), params,
            init_opt_state(M, C, mod.num_params, "cuda"), dev(t_idx),
            dev(slot), dev(tw.sum(-1)))
    kw = dict(hidden=mod.hidden_dim, batch_size=B, lr=cfg.lr, wd=cfg.wd)
    return args, kw, dict(M=M, C=C, S=S, B=B, F=F, H=mod.hidden_dim,
                          K=mod.num_classes)


def _local_sgd_bound_ms(t_idx, slot, total_w, M: int, C: int, S: int, B: int,
                        F: int, H: int, K: int) -> tuple[float, str]:
    """Least time for one K1 call on the card, counting the active pairs'
    work. Bytes: each distinct batch (client, time step, slot) that an
    active pair draws read once (x and label rows), the pool read once, the
    active pairs' optimizer state read and written, the client params, n
    and loss written, the indices and weights read. Operations: the float32
    work of the active pairs' forward, backward and AMSGrad steps."""
    import torch
    P = F * H + H + H * K + K
    act = total_w > 0                                            # [M, C]
    client = torch.arange(C, device=t_idx.device)[None, :, None]
    batches = torch.stack([client.expand_as(t_idx), t_idx, slot], -1)[act]
    distinct = torch.unique(batches.reshape(-1, 3), dim=0).shape[0]
    active = int(act.sum())
    nbytes = (distinct * B * (4 * F + 4) + M * P * 4
              + active * 2 * (3 * P * 4 + 4) + M * C * (P * 4 + 8)
              + M * C * (2 * S * 4 + 4))
    flops = active * S * (B * (4 * F * H + 6 * H * K + 6 * K + 2 * H)
                          + 14 * P)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops \
        else (t_ops * 1e3, "operations")


# K1's cases: (label, dataset, seed, fnn hidden width, forced route); the
# registry's widths take the fused kernel, H = 32 the general one, and the
# general one forced at the SEA shape is the first design, timed here too
K1_CASES = (("sea", "sea", 0, 10, None), ("sine", "sine", 1, 10, None),
            ("sea_general", "sea", 0, 10, "general"),
            ("h32", "sea", 2, 32, None))


def phase_train_kernel() -> dict:
    import torch
    from feddrift_torch.kernels.local_sgd import (_route, local_sgd,
                                                  local_sgd_ref)
    entry, device_ms = None, {}
    for label, dataset, seed, hidden, forced in K1_CASES:
        args, kw, dims = _train_case(dataset, seed, hidden)
        x, y, params, opt, t_idx, slot, total_w = args
        route = forced or _route(dims["F"], dims["H"], dims["K"], dims["B"])
        kw = dict(kw, route=route)
        fresh = lambda: {k: v.clone() for k, v in opt.items()}
        client, k_opt, n, loss = local_sgd(x, y, params, fresh(), t_idx, slot,
                                           total_w, **kw)
        again = local_sgd(x, y, params, fresh(), t_idx, slot, total_w, **kw)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(a, b) for a, b in zip(
            (client, loss, n, *k_opt.values()),
            (again[0], again[3], again[2], *again[1].values())))
        r_client, r_opt, r_n, r_loss = local_sgd_ref(
            x, y, params, fresh(), t_idx, slot, total_w,
            **{k: v for k, v in kw.items() if k != "route"})
        err = max(float((client - r_client).abs().max()),
                  float((loss - r_loss).abs().max()),
                  float((k_opt["mu"] - r_opt["mu"]).abs().max()))
        over = int(((client - r_client).abs() > TRAIN_ATOL).sum())
        nu_rel = max(float(((k_opt[k] - r_opt[k]).abs()
                            / r_opt[k].abs().clamp_min(1e-30)).max())
                     for k in ("nu", "nu_max"))
        inactive = total_w == 0
        untouched = bool(torch.equal(client[inactive],
                                     params[:, None].expand_as(client)
                                     [inactive])
                         and (k_opt["count"][inactive] == 0).all()
                         and (n[inactive] == 0).all())
        same = bool(torch.equal(n, r_n)
                    and torch.equal(k_opt["count"], r_opt["count"]))
        state = fresh()
        calls = {"kernel": lambda: local_sgd(x, y, params, state, t_idx, slot,
                                             total_w, **kw),
                 "plain": lambda: local_sgd_ref(
                     x, y, params, state, t_idx, slot, total_w,
                     **{k: v for k, v in kw.items() if k != "route"})}
        ms, plain_ms = _interleaved(_time_ms, calls).values()
        device = {name: _device_ms(f) for name, f in calls.items()}
        device_ms[label] = device["kernel"]
        enqueue_ms = _host_enqueue_ms(calls["kernel"])
        active = int((total_w > 0).sum())
        bound_ms, bound_by = _local_sgd_bound_ms(t_idx, slot, total_w,
                                                 **dims)
        _say("train_kernel", name="local_sgd", case=label, dataset=dataset,
             route=route, **dims, active_pairs=active, max_abs_err=err,
             atol=TRAIN_ATOL, coords_over_atol=over, nu_max_rel_err=nu_rel,
             nu_rtol=TRAIN_NU_RTOL, inactive_untouched=untouched,
             n_and_count_equal=same, two_calls_bitwise=bitwise,
             kernel_ms=ms, plain_ms=plain_ms,
             kernel_device_ms=device["kernel"], kernel_enqueue_ms=enqueue_ms,
             step_us=device["kernel"] * 1e3 / dims["S"]
             if device["kernel"] else "not measured",
             plain_device_ms=device["plain"], bound_ms=bound_ms,
             bound_by=bound_by, kernel_vs_bound=(device["kernel"] or ms)
             / bound_ms)
        if not (err <= TRAIN_ATOL and nu_rel <= TRAIN_NU_RTOL and untouched
                and same and bitwise):
            raise AssertionError(f"local_sgd ({label}, {route}): |kernel - "
                                 f"plain| {err} (atol {TRAIN_ATOL}), nu rel "
                                 f"{nu_rel}, inactive untouched {untouched}, "
                                 f"n/count equal {same}, two calls bitwise "
                                 f"{bitwise}")
        if label == "sea":
            if route != "fused":
                raise AssertionError(f"the canonical shape took the {route} "
                                     f"kernel")
            entry = {"name": "local_sgd", "route": "cuda",
                     "source": "feddrift_torch/kernels/csrc/local_sgd.cu",
                     "replaces": "feddrift_tpu/core/step.py:225",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": None,
                     "device_ms": device["kernel"]}
    fused, general = device_ms["sea"], device_ms["sea_general"]
    _say("train_kernel", what="canonical_shape_by_kernel",
         fused_device_ms=fused, general_device_ms=general,
         fused_vs_general=fused / general if fused and general
         else "not measured",
         first_design_device_ms_recorded=K1_FIRST_DESIGN_DEVICE_MS,
         bound_ms=entry["bound_ms"])
    return entry


def phase_train_plain() -> None:
    """The two other device steps of a round, plain PyTorch on the card for
    now (K2: the masked FedAvg; K3: the eval matrices), at the canonical
    shapes: per call and device time against the bound of each."""
    import torch
    from feddrift_torch.kernels.local_sgd import local_sgd
    from feddrift_torch.models.mlp import FeedForwardNN
    from feddrift_torch.resilience.robust_agg import agg_mean
    from feddrift_torch.core.step import TrainStep
    args, kw, d = _train_case("sea", 0)
    x, y, params, opt, t_idx, slot, total_w = args
    client, _, n, _ = local_sgd(*args, **kw)
    M, C, P = client.shape
    N = x.shape[2]
    step = TrainStep(FeedForwardNN((d["F"],), d["K"], d["H"]), d["B"],
                     d["S"], d["K"])
    tree = step.module.unpack(params)
    calls = {
        "masked_fedavg": (lambda: agg_mean(client, n, params),
                          4 * (M * C * P + M * C + 2 * M * P + 3 * M), 3 * M
                          * C * P),
        "acc_matrix": (lambda: step.acc_matrix(tree, x[:, 0], y[:, 0]),
                       4 * (C * N * (d["F"] + 1) + M * P + 2 * M * C),
                       M * C * N * (2 * d["F"] * d["H"] + 2 * d["H"]
                                    * d["K"] + 6 * d["K"])),
        "acc_cells": (lambda: step.acc_cells(tree, x, y),
                      4 * (x.numel() + y.numel() + M * P
                           + M * C * x.shape[1]),
                      M * x.numel() // d["F"] * (2 * d["F"] * d["H"]
                                                 + 2 * d["H"] * d["K"]))}
    for name, (fn, nbytes, flops) in calls.items():
        ms = _time_ms(fn)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
        _say("train_plain", name=name, ms=ms, device_ms=_device_ms(fn),
             launches_per_call=_launches(fn),
             bound_ms=max(t_bytes, t_ops) * 1e3,
             bound_by="bytes" if t_bytes >= t_ops else "operations")


def _launches(fn, reps: int = 5) -> float:
    kernels, _ = _profile(fn, reps)
    return sum(e.count for e in kernels) / reps


def _reference_accs() -> list[float]:
    """Final Test/Acc of each step of the committed reference run. Refuses
    a file that holds more than one run (its rounds do not rise strictly:
    ``python -m feddrift_torch run`` with the default ``--out_dir`` appends
    to this very file) or whose values are not the committed ones."""
    final, rounds = {}, []
    with open(REF_RUN) as f:
        for line in f:
            rec = json.loads(line)
            rounds.append(rec["round"])
            final[rec["iteration"]] = rec["Test/Acc"]
    accs = [final[t] for t in sorted(final)]
    if rounds != sorted(set(rounds)) or accs != list(REF_ACCS):
        raise AssertionError(f"{REF_RUN} is not the committed reference run "
                             f"(one run, final Test/Acc {REF_ACCS}); got "
                             f"rounds {rounds} and final Test/Acc {accs}")
    return accs


def phase_train(entry: dict) -> None:
    import collections
    import tempfile

    import torch
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.core import step as step_mod
    from feddrift_torch.kernels.local_sgd import _route, local_sgd
    from feddrift_torch.simulation.runner import Experiment
    from feddrift_torch.utils.prng import iteration_seed
    cfg = ExperimentConfig()
    ref = _reference_accs()
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        exp = Experiment(cfg, out_dir=out_dir)
        setup_s = time.perf_counter() - t0
        # calls of the plain K2 / K3 steps during the run, counted by name
        counts = collections.Counter()

        def counted(name, fn):
            def inner(*a, **k):
                counts[name] += 1
                return fn(*a, **k)
            return inner
        plain = {"agg_mean": step_mod.agg_mean}
        step_mod.agg_mean = counted("masked_fedavg", plain["agg_mean"])
        exp.step._acc_matrix_body = counted("acc_matrix",
                                            exp.step._acc_matrix_body)
        exp.step.acc_cells = counted("acc_cells", exp.step.acc_cells)
        local_sgd.launches = 0
        try:
            t0 = time.perf_counter()
            exp.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            step_mod.agg_mean = plain["agg_mean"]
            del exp.step._acc_matrix_body, exp.step.acc_cells
        launches = local_sgd.launches
        ckpt = os.path.isfile(os.path.join(out_dir, "ckpt", "MANIFEST.json"))
        ends = exp.events.events("iteration_end")
        models = [e["num_models"] for e in exp.events.events("cluster_state")]
        final = {}
        for rec in exp.logger.history:
            final[rec["iteration"]] = rec["Test/Acc"]
        accs = [final[t] for t in sorted(final)]
        for t, e in enumerate(ends):
            _say("train_step", iteration=t, wall_s=e["wall_s"],
                 rounds_per_s=e["rounds_per_s"], test_acc=accs[t],
                 reference_test_acc=ref[t], models_in_use=models[t])
        entry["launches"] = launches
        # one more time step under the profiler: where its wall goes
        R, freq = cfg.comm_round, cfg.frequency_of_the_test
        T = cfg.train_iterations
        params = exp.pool.params
        opt = exp.step.init_opt_states(params, exp.pool.num_models, exp.C_)
        tw = exp.algo.round_inputs(T - 1, 0)[0]
        exp.step.generator.manual_seed(iteration_seed(cfg.seed, T - 1))
        kernels, prof_us = _profile(
            lambda: exp.step.train_iteration_eval(
                params, {k: v.clone() for k, v in opt.items()}, exp.x, exp.y,
                tw, 1.0, R, freq, T - 1), 1)
        busy_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        mean_acc = sum(accs) / len(accs)
        ref_mean = sum(ref) / len(ref)
        diffs = [a - b for a, b in zip(accs, ref)]
        mod = exp.step.module
        route = _route(exp.x.shape[-1], mod.hidden_dim, mod.num_classes,
                       min(cfg.batch_size, exp.x.shape[2]))
        _say("train", dataset=cfg.dataset, model=cfg.model,
             algo=cfg.concept_drift_algo, algo_arg=cfg.concept_drift_algo_arg,
             steps=len(ends), rounds=exp.global_round, setup_s=setup_s,
             wall_s=wall, local_sgd_launches=launches,
             local_sgd_route=route,
             plain_calls=dict(counts), checkpoint=ckpt,
             test_acc_mean=mean_acc, reference_mean=ref_mean,
             max_step_diff=max(map(abs, diffs)),
             profiled_step_wall_ms=prof_us / 1e3,
             profiled_step_device_busy_ms=busy_us / 1e3,
             device_busy_share=busy_us / prof_us if busy_us
             else "not measured",
             kernel_launches_per_round=sum(e.count for e in kernels) / R,
             top_kernels_us_per_round={e.key[:60]: e.self_device_time_total / R
                                       for e in top})
        want = cfg.train_iterations * cfg.comm_round
        if len(ends) != cfg.train_iterations or len(accs) != len(ref):
            raise AssertionError(f"{len(ends)} of {cfg.train_iterations} "
                                 f"steps ran")
        if not ckpt:
            raise AssertionError("no checkpoint was written")
        if launches != want or route != "fused":
            raise AssertionError(f"local_sgd launched {launches} times for "
                                 f"{want} rounds, through the {route} "
                                 f"kernel")
        if max(map(abs, diffs)) > STEP_ACC_TOL \
                or abs(mean_acc - ref_mean) > MEAN_ACC_TOL:
            raise AssertionError(f"Test/Acc per step {accs} against the "
                                 f"reference {ref}")


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
        dense_entry = phase_dense()
        phase_serve(entry, dense_entry)
        train_entry = phase_train_kernel()
        phase_train_plain()
        phase_train(train_entry)
    except Exception:   # noqa: BLE001 — report the phase that failed
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [entry, train_entry, dense_entry]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
