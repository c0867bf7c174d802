"""K1's and K3's kernels of two checkouts of the PyTorch port on one card,
in turns: ptxas' registers per thread, the time of each kernel at its
canonical shape, and whether the two sides' outputs are bitwise equal.

    python3 scripts/torch_kernel_ab.py --base DIR [--repeat K]
        [--changed CASE,..] [--cases CASE,..]

``DIR`` is a second checkout of the repository (for example the parent
commit unpacked with ``git archive``); the checkout this script lives in is
the other side. Child processes run in turns, base, this, this, base (``--repeat K``
times). Each imports ``feddrift_torch`` and ``chip_smoke`` from its side's
checkout, builds that side's kernels there, and for each case, on
``chip_smoke``'s inputs: K1's fused kernel with its K2 epilogue
(``local_sgd_fedavg``, SEA), the same launch with the folded eval, K1's
general kernel forced at SEA (the fnn under AMSGrad and SGD, the lr under
AMSGrad), its wide kernel at MNIST-4's width (the same three) and at
femnist-fnn's (784 -> 10 -> 62, two classes a lane), its split kernel at
fmow's (the fnn under AMSGrad and SGD), and at susy's width (18 -> 10 ->
2) and ro's (5 -> 10 -> 2) its default route (the fused kernel since it
folds in chunks; the general one before) and the general one forced; K3's
fused and general kernels at SEA (G = 2), its wide route at MNIST-4's
width (G = 2) and at fmow's (G = 2 and every step, T1), its default route
at susy's (G = 2). ``k1_susy_fused_eval`` and ``k1_ro_fused_eval`` (the
fused round with its epilogue and the eval folded in) run only where
``--cases`` names them: both sides must take the fused route there. It prints one
``ab_kernel`` JSON line a side and case: ms a call (CUDA events), device
ms (torch.profiler), and a sha256 of every output of a fresh call; and one
``ab_ptxas`` line a side with ptxas' registers and spills of every kernel
of ``csrc/local_sgd.cu`` and ``csrc/eval_cells.cu``. The last line,
``ab``, says for each case whether the sides' outputs are bitwise equal,
and each side's ms a call (the mean of its turns). ``--changed`` names
the cases whose kernel the two sides compute in another order (a
redesign): they need not be equal across the sides, only each side's
calls among themselves. ``--cases`` runs only the cases named (all by
default). Exits non-zero if a child failed or any other case differs.
Needs one CUDA card.

A launch parameter is swept the same way: ``DIR`` a copy of this checkout
with the parameter changed in its source, and ``--cases`` the cases that
take that kernel.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

ORDER = ("base", "this", "this", "base")
CASES = ("k1_fused", "k1_fused_eval", "k1_general", "k1_general_sgd",
         "k1_general_lr", "k1_wide", "k1_wide_sgd", "k1_wide_lr",
         "k1_wide_femnist", "k1_split",
         "k1_split_sgd", "k1_susy", "k1_susy_general", "k1_ro", "k3_fused",
         "k3_general", "k3_wide", "k3_fmow", "k3_fmow_cells", "k3_susy")
# cases whose call needs the fused route at susy's and ro's widths on both
# sides (K2 as the epilogue, the eval folded in): name them in --cases
FUSED_TABULAR = ("k1_susy_fused_eval", "k1_ro_fused_eval")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child(cases) -> None:
    import torch

    import chip_smoke as cs
    from feddrift_torch.kernels import build
    from feddrift_torch.kernels.eval_cells import eval_cells
    from feddrift_torch.kernels.local_sgd import local_sgd, local_sgd_fedavg
    build.build_all()
    print("ab_ptxas: " + json.dumps(
        {src: cs._ptxas_per_kernel(build.build_log.get(src, ""))
         for src in ("local_sgd.cu", "eval_cells.cu")}), flush=True)

    def k1(dataset, route=None, fused=False, fold=False, model="fnn",
           optimizer="adam"):
        args, kw, _, _ = cs._train_case(dataset, 0, 10, model, optimizer)
        x, y, params, opt, t_idx, slot, total_w = args
        fresh = lambda: {k: v.clone() for k, v in opt.items()}
        extra = {}
        if fold:
            corr = torch.empty((*params.shape[:1], x.shape[0], 2),
                               dtype=torch.int32, device="cuda")
            nll = torch.empty(corr.shape, device="cuda")
            extra = dict(eval_window=(x[:, 4:6].flatten(3), y[:, 4:6]),
                         eval_out=(corr, nll))

        def call(state):
            if fused:
                out = local_sgd_fedavg(x, y, params, state, t_idx, slot,
                                       total_w, **kw, **extra)
                return [out[0], *out[1].values(), *out[2:5]] \
                    + (list(extra["eval_out"]) if fold else [])
            out = local_sgd(x, y, params, state, t_idx, slot, total_w,
                            route=route, optimizer=optimizer, **kw)
            return [out[0], *out[1].values(), out[2], out[3]]
        digest = _digest(call(fresh()))
        state = fresh()
        return digest, lambda: call(state)

    def k3(dataset, route=None, window="G2"):
        flat, xw, yw, fm, d = cs._k3_case(dataset, "fnn", 10, window, False,
                                          0)
        call = lambda: [t for t in eval_cells(
            flat, xw, yw, hidden=d["H"], route=route,
            with_nll=window != "T1") if t is not None]
        return _digest(call()), call

    table = {
        "k1_fused": lambda: k1("sea", fused=True),
        "k1_fused_eval": lambda: k1("sea", fused=True, fold=True),
        "k1_general": lambda: k1("sea", route="general"),
        "k1_general_sgd": lambda: k1("sea", route="general",
                                     optimizer="sgd"),
        "k1_general_lr": lambda: k1("sea", route="general", model="lr"),
        "k1_wide": lambda: k1("MNIST"),
        "k1_wide_sgd": lambda: k1("MNIST", optimizer="sgd"),
        "k1_wide_lr": lambda: k1("MNIST", model="lr"),
        "k1_wide_femnist": lambda: k1("femnist"),
        "k1_split": lambda: k1("fmow"),
        "k1_split_sgd": lambda: k1("fmow", optimizer="sgd"),
        "k1_susy": lambda: k1("susy"),
        "k1_susy_general": lambda: k1("susy", route="general"),
        "k1_ro": lambda: k1("ro"),
        "k1_susy_fused_eval": lambda: k1("susy", fused=True, fold=True),
        "k1_ro_fused_eval": lambda: k1("ro", fused=True, fold=True),
        "k3_fused": lambda: k3("sea"),
        "k3_general": lambda: k3("sea", route="general"),
        "k3_wide": lambda: k3("MNIST"),
        "k3_fmow": lambda: k3("fmow"),
        "k3_fmow_cells": lambda: k3("fmow", window="T1"),
        "k3_susy": lambda: k3("susy")}
    for label in cases:
        digest, fn = table[label]()
        wide = any(w in label for w in ("wide", "split", "fmow"))
        print("ab_kernel: " + json.dumps({
            "case": label, "sha256": digest,
            "ms": cs._time_ms(fn, iters=20 if wide else 100),
            "device_ms": cs._device_ms(fn, reps=10 if wide else 50)}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--changed", default="",
                    help="cases redesigned between the sides, comma "
                         "separated")
    ap.add_argument("--cases", default="",
                    help="the cases to run, comma separated (all by "
                         "default)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = tuple(filter(None, args.cases.split(","))) or CASES
    if set(cases) - set(CASES + FUSED_TABULAR):
        ap.error(f"unknown cases "
                 f"{sorted(set(cases) - set(CASES + FUSED_TABULAR))}")
    if args.child:
        child(cases)
        return 0
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"base": os.path.abspath(args.base), "this": this}
    got: dict[str, dict] = {"base": {}, "this": {}}
    ms: dict[str, dict] = {"base": {}, "this": {}}
    for _ in range(args.repeat):
        for side in ORDER:
            env = dict(os.environ, PYTHONPATH=roots[side])
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 "--cases", ",".join(cases)],
                cwd=roots[side], env=env, capture_output=True, text=True,
                timeout=900)
            sys.stderr.write(out.stderr[-4000:])
            if out.returncode != 0:
                print(f"ab: the {side} child failed", flush=True)
                return 1
            for line in out.stdout.splitlines():
                print(f"{side} {line}", flush=True)
                if line.startswith("ab_kernel: "):
                    rec = json.loads(line.split(": ", 1)[1])
                    got[side].setdefault(rec["case"], set()).add(
                        rec["sha256"])
                    ms[side].setdefault(rec["case"], []).append(rec["ms"])
    changed = set(filter(None, args.changed.split(",")))
    equal = {c: got["base"].get(c) == got["this"].get(c)
             and len(got["this"].get(c, ())) == 1 for c in cases}
    steady = {c: all(len(got[s].get(c, ())) == 1 for s in got)
              for c in cases}
    mean = {s: {c: sum(v) / len(v) for c, v in ms[s].items()} for s in ms}
    print("ab: " + json.dumps({
        "bitwise_equal": equal, "changed": sorted(changed),
        "ms_base": mean["base"], "ms_this": mean["this"],
        "this_vs_base": {c: mean["this"][c] / mean["base"][c]
                         for c in mean["this"] if c in mean["base"]}}),
        flush=True)
    ok = all(equal[c] if c not in changed else steady[c] for c in cases)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
