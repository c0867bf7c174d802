"""How far rounding alone moves MNIST-4's (or another dataset's) Test/Acc
on the card: the win-1 and oblivious runs of ``chip_smoke.py``'s
``MNIST_RUNS`` (or ``FMOW_RUNS``, ``TABULAR_RUNS``' or ``IMAGE_RUNS``' runs
of the dataset; 10 steps, the reference's init) through K1's kernel of that
width (the wide one; fmow's: the split one; susy's and ro's: the fused
one, K2 its epilogue and the evals folded in), the same kernel with its
cluster sum taken in reverse rank order (a copy of ``csrc/local_sgd.cu``
built beside the package's: the wide kernel's gradient sum, the split
kernel's sum of Z1's partials), at MNIST's width the general kernel, and
the plain version (``local_sgd_ref`` on the card, on the batch rows as drawn
and permuted within each batch, with K2 and K3 launched on their own).
Each changes only the order of float32 sums. ``--plain_only`` runs the plain variants alone: the envelope from
which a gate is fixed before any kernel's run of the dataset is read.

    python3 scripts/torch_rounding_spread.py [--runs win-1,oblivious]
        [--dataset MNIST|fmow|susy|ro|stackoverflow_lr|femnist|cifar10]
        [--permutations 2] [--plain_only]

One JSON line a (variant, run): its Test/Acc per step, mean, and the
committed run's mean where there is one (beyond MNIST also its largest
distance a step and on the mean from the series its gate holds it to: the
JAX package's CPU run from the same init, ``chip_smoke.FMOW_REFERENCE_ACCS``
or ``NEW_REFERENCE_ACCS``, else the committed run); then one line with the
spread of each run's means and, beyond MNIST, the plain variants'
envelope: the largest of those distances over the plain version's runs,
from which ``chip_smoke.FMOW_RUNS`` and ``NEW_PLAIN_ENVELOPE`` take their
gates.
Needs a CUDA card (exits 1 without one); takes ~2 minutes at MNIST's width
(the general kernel and the plain version take ~40 s and ~20 s a run).
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
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the cluster sums the reversed variant turns around, by K1's kernel: the
# wide kernel's gradient partials, the split kernel's Z1 partials
REVERSED_SUMS = {
    "wide": (("      for (int r = 0; r < kWideMaxCluster; ++r) {\n"
              "        if (r >= Q) break;\n        g[0] += part[r].x;\n"
              "        g[1] += part[r].y;\n        g[2] += part[r].z;\n"
              "        g[3] += part[r].w;\n      }\n"),
             ("      for (int rr = 0; rr < kWideMaxCluster; ++rr) {\n"
              "        if (rr >= Q) break;\n        const int r = Q - 1 - rr;\n"
              "        g[0] += part[r].x;\n        g[1] += part[r].y;\n"
              "        g[2] += part[r].z;\n        g[3] += part[r].w;\n"
              "      }\n")),
    "split": (("          for (int rk = 0; rk < Q; ++rk)\n"
               "            v += cluster.map_shared_rank(s_zp, rk)"
               "[(o0 + r) * H + lane];\n"),
              ("          for (int rk = Q - 1; rk >= 0; --rk)\n"
               "            v += cluster.map_shared_rank(s_zp, rk)"
               "[(o0 + r) * H + lane];\n"))}


def reversed_sum_kernel(build, tmp: str, route: str = "wide"):
    """local_sgd_f32 from a copy of the source whose cluster sum (of the
    ``route`` kernel) runs from rank Q - 1 down to 0."""
    src_dir = os.path.join(ROOT, "feddrift_torch", "kernels", "csrc")
    dst = os.path.join(tmp, "csrc")
    shutil.copytree(src_dir, dst)
    path = os.path.join(dst, "local_sgd.cu")
    src = open(path).read()
    loop, turned = REVERSED_SUMS[route]
    if src.count(loop) != 1:
        raise RuntimeError("the cluster sum's loop is not where it was")
    src = src.replace(loop, turned)
    open(path, "w").write(src)
    lib = os.path.join(tmp, "local_sgd_reversed.so")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(lib).local_sgd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="win-1,oblivious")
    ap.add_argument("--dataset", default="MNIST",
                    choices=("MNIST", "fmow", "susy", "ro",
                             "stackoverflow_lr", "femnist", "cifar10"))
    ap.add_argument("--permutations", type=int, default=2,
                    help="plain runs on batch rows permuted within a batch")
    ap.add_argument("--plain_only", action="store_true",
                    help="the plain variants only (no kernel's run)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_rounding_spread: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import feddrift_torch.core.step as step_mod
    from feddrift_torch.config import ExperimentConfig
    from feddrift_torch.kernels import build
    from feddrift_torch.models.mlp import FeedForwardNN
    k1 = importlib.import_module("feddrift_torch.kernels.local_sgd")
    card = cs.phase_device()
    build.build_all()
    fmow, new = args.dataset == "fmow", args.dataset in cs.NEW_DATASETS
    if new:
        shape, classes, width, _ = cs.NEW_DATASETS[args.dataset]
        path = cs._reference_init(args.dataset)
        table = {**cs.TABULAR_RUNS, **cs.IMAGE_RUNS}[args.dataset]
        # the series each run's gate holds it to: the JAX package's run,
        # else the committed one
        reference = {r[0]: cs.NEW_REFERENCE_ACCS.get(args.dataset, {})
                     .get(r[0], r[5]) for r in table}
        reference = {k: v for k, v in reference.items() if v is not None}
    else:
        shape, classes = ((32, 32, 3), 62) if fmow else ((784,), 10)
        path = cs.FMOW_REFERENCE_INIT if fmow else cs.MNIST_REFERENCE_INIT
        table = cs.FMOW_RUNS if fmow else cs.MNIST_RUNS
        reference = cs.FMOW_REFERENCE_ACCS if fmow else {}
        width = "split" if fmow else "wide"
    init = FeedForwardNN(shape, classes, 10).unpack(
        torch.from_numpy(np.load(path)))
    runs = {r[0]: r for r in table if r[0] in args.runs.split(",")}
    kernel, route, k1_fn = k1._kernel, k1._route, step_mod.local_sgd
    step_route, step_folds = step_mod._route, step_mod._folds_eval

    def on_plain(fn):
        # the round then calls local_sgd (the plain version) and agg_mean,
        # never the fused route's local_sgd_fedavg, and launches K3 for
        # every eval (susy's and ro's widths are fused otherwise)
        step_mod.local_sgd = fn
        step_mod._route = lambda *a, **k: "general"
        step_mod._folds_eval = lambda *a, **k: False

    def plain_on(perm):
        def plain(x, y, flat, opt, t_idx, slot, tw, *, batch_size,
                  optimizer="adam", idx=None, **kw):
            N = x.shape[2]
            rows = (t_idx.long() * N + slot.long() * batch_size)[..., None] \
                + perm
            return k1.local_sgd_ref(x, y, flat, opt, None, None, tw,
                                    batch_size=batch_size, idx=rows.int(),
                                    optimizer=optimizer, **kw)
        return plain

    means, envelope = {}, {}
    def permuted(seed):
        return lambda: on_plain(plain_on(
            torch.from_numpy(np.random.default_rng(seed).permutation(500))
            .cuda()))

    with tempfile.TemporaryDirectory() as tmp:
        reversed_fn = None if args.plain_only \
            or width in ("general", "fused") \
            else reversed_sum_kernel(build, tmp, width)
        variants = () if args.plain_only else (
            (width, lambda: None),
            *(() if reversed_fn is None else (
                (width + "_sum_reversed",
                 lambda: setattr(k1, "_kernel", lambda: reversed_fn)),)),
            # MNIST's width only: the general kernel refuses fmow's (shared
            # memory), and the new datasets' kernels are their own
            *(() if fmow or new else (("general", lambda: setattr(
                k1, "_route", lambda F, H, K, B, o="adam": "general")),)),)
        variants += (
            ("plain", lambda: on_plain(plain_on(
                torch.arange(500, device="cuda")))),
            *((f"plain_rows_permuted_{i}", permuted(i))
              for i in range(1, args.permutations + 1)))
        for name, setup in variants:
            for algo, (_, arg, pool, T, run, pinned, _, mean_tol) \
                    in runs.items():
                k1._kernel, k1._route = kernel, route
                step_mod.local_sgd = k1_fn
                step_mod._route, step_mod._folds_eval = step_route, \
                    step_folds
                setup()
                cfg = ExperimentConfig(dataset=args.dataset,
                                       concept_drift_algo=algo,
                                       concept_drift_algo_arg=arg,
                                       concept_num=pool, train_iterations=T)
                t0 = time.time()
                got = cs._drive(cfg, init=init, syncs=False)
                accs = got["accs"]
                mean = sum(accs) / len(accs)
                ref = None if pinned is None else sum(pinned[:T]) / T
                means.setdefault(algo, {})[name] = mean
                dist = {}
                if algo in reference:
                    want = reference[algo][:T]
                    dist = {"reference_test_acc": want,
                            "max_step_from_reference": max(
                                abs(a - b) for a, b in zip(accs, want)),
                            "mean_from_reference": abs(mean - sum(want) / T)}
                    if name.startswith("plain"):
                        env = envelope.setdefault(algo, {"step": 0.0,
                                                         "mean": 0.0})
                        env["step"] = max(env["step"],
                                          dist["max_step_from_reference"])
                        env["mean"] = max(env["mean"],
                                          dist["mean_from_reference"])
                print(json.dumps({"variant": name, "run": algo,
                                  "test_acc": accs, "mean": mean, **dist,
                                  "committed_mean": ref,
                                  "mean_minus_committed": None if ref is None
                                  else mean - ref,
                                  "mean_tol": mean_tol,
                                  "wide_launches": got["k1_wide_launches"],
                                  "split_launches":
                                  got["k1_split_launches"],
                                  "seconds": time.time() - t0}), flush=True)
        k1._kernel, k1._route = kernel, route
        step_mod.local_sgd = k1_fn
        step_mod._route, step_mod._folds_eval = step_route, step_folds
    print(json.dumps({"card": card, "spread_of_means": {
        algo: {"min": min(v.values()), "max": max(v.values())}
        for algo, v in means.items()}, "plain_envelope": envelope}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
