"""Where a step of K1's wide or split kernel goes on the card: a copy of
``csrc/local_sgd.cu`` with ``%globaltimer`` reads at the kernel's phase
boundaries (``KERNELS``: the text each mark goes beside, and the phases
between marks), built beside the package's and run at ``chip_smoke.py``'s
case of that width for ranks 0 and 15 of the first cluster; then the
package's kernel timed (CUDA events) at other launch shapes: the round, one
wave of pairs, one pair alone, and one pair whose batch stays in L2.

    python3 scripts/torch_wide_breakdown.py [--kernel wide|split]

The wide kernel runs at MNIST-4's shape (M 4, C 10, B 500, S 5; the fnn
784 -> 10 -> 10 and the lr 784 -> 10 under AMSGrad), the split one at
fmow's (the fnn 3072 -> 10 -> 62). One JSON line a (model, rank, step):
nanoseconds in each phase (the split kernel: also the time thread 0 waited
for x's tiles in the two passes); then one line a launch shape (pairs, ms
a call, clusters at once); then the card. Needs a CUDA card (exits 1
without one).
"""

import argparse
import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SLOTS = 16                       # marks a step
STEPS = 8                        # steps recorded at most
# Each kernel: its signature's text, its marks (text before, text after,
# mark k: the read goes between the two, which occur once in the kernel's
# body), the phases between marks 0, 1, ..., the phase before mark 0 (from
# the last step's last mark) or None, the text of its tile wait and of the
# line it is declared after (thread 0's waits a step summed into slot 9) or
# None, and its cases: (dataset, seed, model).
KERNELS = {
    "wide": dict(
        signature="local_sgd_wide_kernel(const Args a) {",
        marks=(
            ("    mbar_wait(bar, (unsigned)s & 1u);\n", "", 0),
            ("", "    // (2) a warp four rows", 1),
            ("", "    // (3) the small partials over the CTA's rows", 2),
            ("", "    // every read of s_x is done: the next step's rows "
                 "land", 3),
            ("", "    // (4) the cluster: every CTA's partials are visible",
             4),
            ("", "    if constexpr (!kSgd) count = count < INT_MAX ? count "
                 "+ 1 : count;\n", 5),
            ("", "    // the new params are in every CTA, and no CTA reads "
                 "another's", 6),
            ("    cluster.sync();\n",
             "  }\n\n  const float tw = a.total_w[pair];", 7)),
        phases=("forward", "rows", "sums_and_dw1", "stage", "cluster_sync_1",
                "sum_and_update", "cluster_sync_2"),
        lead="wait", tile_wait=None,
        cases=(("MNIST", 4, "fnn"), ("MNIST", 4, "lr"))),
    "split": dict(
        signature="local_sgd_split_kernel(const Args a) {",
        marks=(
            ("", "    // own rows' labels, read now and stored after pass 1;",
             0),
            ("", "    if (tid < nown) s_y[tid] = ylab;\n", 1),
            ("", "    // (2) the row phase, this CTA's rows", 2),
            ("", "    // (3) the small params' partials over the own rows",
             3),
            ("", "    cluster.sync();                 // dh rows, partials "
                 "and losses visible\n", 4),
            ("", "    // (4) CTA q sums its sixteenth of the small params'", 5),
            ("", "    // (5) dW1 = (x * fm)^T dh over every row", 6),
            ("", "    // (6) W1's slice steps here", 7),
            ("", "  }\n  cluster.sync();                   // no CTA leaves",
             8)),
        phases=("pass_1", "cluster_sync_1", "rows", "small_partials",
                "cluster_sync_2", "small_step", "pass_2", "w1_step"),
        lead=None,
        tile_wait=("    mbar_wait(bar + st, (unsigned)((u + d) / kSplitStages) "
                   "& 1u);\n",
                   "  int u = 0;                        // the next tile of "
                   "the stream\n"),
        cases=(("fmow", 12, "fnn"),)),
}


def marked_source(src: str, kernel: str) -> str:
    """``src`` (``csrc/local_sgd.cu``) with ``kernel``'s marks read into
    ``g_marks[rank 0 or 15][step * SLOTS + k]`` and a ``marks_read`` entry
    point that copies them out."""
    spec = KERNELS[kernel]
    head, sig, tail = src.partition(spec["signature"])
    end = tail.index("\n}\n")
    body = tail[:end]
    who = ("(blockIdx.x == 0 || blockIdx.x == 15) && threadIdx.x == 0 && "
           f"s < {STEPS}")

    def read(k):
        return (f"    if ({who}) {{ unsigned long long t; asm volatile("
                "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
                f"g_marks[blockIdx.x == 0 ? 0 : 1][s * {SLOTS} + {k}] = t; "
                "}\n")
    for before, after, k in spec["marks"]:
        if not sig or body.count(before + after) != 1:
            raise RuntimeError(f"{kernel} mark {k}: the kernel's text moved")
        body = body.replace(before + after, before + read(k) + after)
    if spec["tile_wait"]:
        wait, decl = spec["tile_wait"]
        if body.count(wait) != 1 or body.count(decl) != 1:
            raise RuntimeError("the tile wait's text moved")
        body = body.replace(decl, "  unsigned long long g_wait = 0;\n" + decl)
        body = body.replace(wait, (
            "    unsigned long long w0, w1;\n"
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(w0));\n"
            + wait +
            "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(w1));\n"
            "    g_wait += w1 - w0;\n"))
        last = spec["marks"][-1][1]
        body = body.replace(last, (
            f"    if ({who}) g_marks[blockIdx.x == 0 ? 0 : 1][s * {SLOTS} + "
            "9] = g_wait;\n    g_wait = 0;\n") + last)
    src = head + sig + body + tail[end:]
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n__device__ "
                      f"unsigned long long g_marks[2][{STEPS * SLOTS}];\n", 1)
    return src + ('\nextern "C" int marks_read(unsigned long long* out) {\n'
                  "  return (int)cudaMemcpyFromSymbol(out, g_marks, "
                  "sizeof(g_marks));\n}\n")


def instrumented(build, tmp: str, kernel: str):
    dst = os.path.join(tmp, "csrc")
    shutil.copytree(os.path.join(ROOT, "feddrift_torch", "kernels", "csrc"),
                    dst)
    path = os.path.join(dst, "local_sgd.cu")
    with open(path) as f:
        src = marked_source(f.read(), kernel)
    with open(path, "w") as f:
        f.write(src)
    lib_path = os.path.join(tmp, "local_sgd_marked.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(lib_path)


def step_phases(marks, s: int, spec) -> dict:
    """Nanoseconds in each phase of step ``s`` from one rank's marks."""
    m, n = marks[s], len(spec["phases"])
    start = m[0]
    out = {}
    if spec["lead"]:
        start = marks[s - 1, n] if s else m[0]
        out[spec["lead"]] = int(m[0] - start)
    out.update({name: int(m[k] - m[k - 1])
                for k, name in enumerate(spec["phases"], 1)})
    out["step"] = int(m[n] - start)
    if spec["tile_wait"]:
        out["tile_waits_of_passes"] = int(m[9])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="wide", choices=tuple(KERNELS))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from feddrift_torch.kernels import build
    k1 = importlib.import_module("feddrift_torch.kernels.local_sgd")
    spec = KERNELS[args.kernel]
    card = cs.phase_device()
    build.build_all()

    def time_ms(fn, iters=10):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    with tempfile.TemporaryDirectory() as tmp:
        lib = instrumented(build, tmp, args.kernel)
        fn = lib.local_sgd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        kernel = k1._kernel
        for dataset, seed, model in spec["cases"]:
            case, kw, dims, _ = cs._train_case(dataset, seed, 10, model,
                                               "adam")
            x, y, params, opt, t_idx, slot, total_w = case
            k1._kernel = lambda: fn
            for _ in range(2):
                k1.local_sgd(x, y, params, opt, t_idx, slot, total_w, **kw)
            torch.cuda.synchronize()
            k1._kernel = kernel
            buf = (ctypes.c_ulonglong * (2 * STEPS * SLOTS))()
            lib.marks_read(buf)
            marks = np.array(buf, dtype=np.int64).reshape(2, STEPS, SLOTS)
            for rank, name in ((0, 0), (1, 15)):
                for s in range(dims["S"]):
                    print(json.dumps({
                        "kernel": args.kernel, "model": model, "rank": name,
                        "step_index": s,
                        "ns": step_phases(marks[rank], s, spec)}),
                        flush=True)
            # launch shapes: the whole round, one wave, one pair, and one
            # pair whose client's rows (a 1-step x of N rows) stay in L2
            clusters = k1.wide_clusters(dims["F"], dims["H"], dims["K"],
                                        dims["B"], route=args.kernel)
            for label, m, c, steps in (
                    ("round", dims["M"], dims["C"], None),
                    ("one_wave", 1, min(clusters, dims["C"]), None),
                    ("one_pair", 1, 1, None), ("one_pair_in_l2", 1, 1, 1)):
                xs = x[:c] if steps is None else x[:c, :steps].contiguous()
                sub = (xs, y[:c, :xs.shape[1]].contiguous(),
                       params[:m].contiguous(),
                       {k: v[:m, :c].contiguous() for k, v in opt.items()},
                       t_idx[:m, :c].contiguous().clamp_max(xs.shape[1] - 1),
                       slot[:m, :c].contiguous(),
                       total_w[:m, :c].contiguous())
                ms = time_ms(lambda: k1.local_sgd(*sub, **kw))
                print(json.dumps({"kernel": args.kernel, "model": model,
                                  "shape": label, "pairs": m * c, "ms": ms,
                                  "clusters_at_once": clusters}), flush=True)
    print(json.dumps({"card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
