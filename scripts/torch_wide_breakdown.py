"""Where a step of K1's wide kernel goes on the card: a copy of
``csrc/local_sgd.cu`` with ``%globaltimer`` reads at its phase boundaries,
built beside the package's, run at MNIST-4's shape (M 4, C 10, B 500, S 5;
the fnn 784 -> 10 -> 10 and the lr 784 -> 10 under AMSGrad) for ranks 0
and 15 of pair 0, and the kernel's clusters at once.

    python3 scripts/torch_wide_breakdown.py

One JSON line a (model, rank, step): nanoseconds in each phase (the
step's TMA wait, the forward, the row phase, the small sums and dW1, the
next step's staging, the first cluster barrier, the cluster's sum and
update, the second barrier). Needs a CUDA card (exits 1 without one).
"""

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

PHASES = ("wait", "forward", "rows", "sums_and_dw1", "stage", "cluster_sync_1",
          "sum_and_update", "cluster_sync_2")
# (text in the wide kernel, mark, where): each phase ends at its mark
MARKS = (
    ("    mbar_wait(bar, (unsigned)s & 1u);\n", 0, "after"),
    ("    // (2) a warp four rows", 1, "before"),
    ("    // (3) the small partials over the CTA's rows", 2, "before"),
    ("    // every read of s_x is done: the next step's rows land", 3,
     "before"),
    ("    // (4) the cluster: every CTA's partials are visible", 4, "before"),
    ("    if constexpr (!kSgd) count = count < INT_MAX ? count + 1 : count;"
     "\n", 5, "before"),
    ("    // the new params are in every CTA, and no CTA reads another's", 6,
     "before"),
    ("    cluster.sync();\n  }\n\n  const float tw = a.total_w[pair];", 7,
     "end"),
)


def instrumented(build, tmp: str):
    src_dir = os.path.join(ROOT, "feddrift_torch", "kernels", "csrc")
    dst = os.path.join(tmp, "csrc")
    shutil.copytree(src_dir, dst)
    path = os.path.join(dst, "local_sgd.cu")
    src = open(path).read()

    def read(k):
        return ("    if ((blockIdx.x == 0 || blockIdx.x == 15) && threadIdx.x"
                " == 0 && s < 8) { unsigned long long t; asm volatile("
                "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); g_marks["
                f"blockIdx.x == 0 ? 0 : 1][s * 8 + {k}] = t; }}\n")
    for text, k, where in MARKS:
        if src.count(text) != 1:
            raise RuntimeError(f"mark {k}: the kernel's text moved")
        if where == "after":
            src = src.replace(text, text + read(k))
        elif where == "before":
            src = src.replace(text, read(k) + text)
        else:
            src = src.replace(text, "    cluster.sync();\n" + read(k)
                              + "  }\n\n  const float tw = a.total_w[pair];")
    src = src.replace("namespace cg = cooperative_groups;\n",
                      "namespace cg = cooperative_groups;\n__device__ "
                      "unsigned long long g_marks[2][64];\n", 1)
    src += ('\nextern "C" int marks_read(unsigned long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_marks, "
            "sizeof(g_marks));\n}\n")
    open(path, "w").write(src)
    lib_path = os.path.join(tmp, "local_sgd_marked.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib_path,
                           path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    return ctypes.CDLL(lib_path)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from feddrift_torch.kernels import build
    k1 = importlib.import_module("feddrift_torch.kernels.local_sgd")
    card = cs.phase_device()
    build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        lib = instrumented(build, tmp)
        fn = lib.local_sgd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
        kernel = k1._kernel
        k1._kernel = lambda: fn
        for model in ("fnn", "lr"):
            args, kw, dims, _ = cs._train_case("MNIST", 4, 10, model, "adam")
            x, y, params, opt, t_idx, slot, total_w = args
            for _ in range(2):
                k1.local_sgd(x, y, params, opt, t_idx, slot, total_w, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 128)()
            lib.marks_read(buf)
            marks = np.array(buf, dtype=np.int64).reshape(2, 8, 8)
            for rank, name in ((0, 0), (1, 15)):
                for s in range(dims["S"]):
                    m = marks[rank, s]
                    start = marks[rank, s - 1, 7] if s else m[0]
                    out = {"wait": int(m[0] - start)}
                    out.update({PHASES[k]: int(m[k] - m[k - 1])
                                for k in range(1, 8)})
                    out["step"] = int(m[7] - start)
                    print(json.dumps({"model": model, "rank": name,
                                      "step_index": s, "ns": out}),
                          flush=True)
        k1._kernel = kernel
    print(json.dumps({"card": card, "clusters_at_once": {
        model: k1.wide_clusters(784, h, 10, 500)
        for model, h in (("fnn", 10), ("lr", 0))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
