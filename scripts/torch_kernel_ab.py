"""K1's and K3's kernels of two checkouts of the PyTorch port on one card,
in turns: ptxas' registers per thread, the time of each kernel at its
canonical shape, and whether the two sides' outputs are bitwise equal.

    python3 scripts/torch_kernel_ab.py --base DIR [--repeat K]

``DIR`` is a second checkout of the repository (for example the parent
commit unpacked with ``git archive``); the checkout this script lives in is
the other side. Child processes run in turns, base, this, this, base (``--repeat K``
times). Each imports ``feddrift_torch`` and ``chip_smoke`` from its side's
checkout, builds that side's kernels there, and for each case, on
``chip_smoke``'s inputs: K1's fused kernel with its K2 epilogue
(``local_sgd_fedavg``, SEA), the same launch with the folded eval, K1's
general kernel forced at SEA (the fnn under AMSGrad and SGD, the lr under
AMSGrad), its wide kernel at MNIST-4's width (the same three) and its split
kernel at fmow's (the fnn under AMSGrad and SGD); K3's
fused and general kernels at SEA (G = 2) and its wide kernel at MNIST-4's
width. It prints one ``ab_kernel`` JSON line a side and case: ms a call
(CUDA events), device ms (torch.profiler), and a sha256 of every output
of a fresh call; and one ``ab_ptxas`` line a side with ptxas' registers
and spills of every kernel of ``csrc/local_sgd.cu`` and
``csrc/eval_cells.cu``. The last line, ``ab``, says for each case whether
the sides' outputs are bitwise equal. Exits non-zero if a child failed or
any case differs. Needs one CUDA card.
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
         "k1_general_lr", "k1_wide", "k1_wide_sgd", "k1_wide_lr", "k1_split",
         "k1_split_sgd", "k3_fused", "k3_general", "k3_wide")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child() -> None:
    import torch

    import chip_smoke as cs
    from feddrift_torch.kernels import build
    from feddrift_torch.kernels.eval_cells import eval_cells
    from feddrift_torch.kernels.local_sgd import local_sgd, local_sgd_fedavg
    build.build_all()
    print("ab_ptxas: " + json.dumps(
        {src: cs._ptxas_per_kernel(build.build_log.get(src, ""))
         for src in ("local_sgd.cu", "eval_cells.cu")}), flush=True)

    def k1(label, dataset, route=None, fused=False, fold=False,
           model="fnn", optimizer="adam"):
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
        return label, digest, lambda: call(state)

    def k3(label, dataset, route=None):
        flat, xw, yw, fm, d = cs._k3_case(dataset, "fnn", 10, "G2", False, 0)
        call = lambda: eval_cells(flat, xw, yw, hidden=d["H"], route=route)
        return label, _digest(call()), call

    for label, digest, fn in (
            k1("k1_fused", "sea", fused=True),
            k1("k1_fused_eval", "sea", fused=True, fold=True),
            k1("k1_general", "sea", route="general"),
            k1("k1_general_sgd", "sea", route="general", optimizer="sgd"),
            k1("k1_general_lr", "sea", route="general", model="lr"),
            k1("k1_wide", "MNIST"),
            k1("k1_wide_sgd", "MNIST", optimizer="sgd"),
            k1("k1_wide_lr", "MNIST", model="lr"),
            k1("k1_split", "fmow"), k1("k1_split_sgd", "fmow",
                                       optimizer="sgd"),
            k3("k3_fused", "sea"), k3("k3_general", "sea", route="general"),
            k3("k3_wide", "MNIST")):
        wide = "wide" in label or "split" in label
        print("ab_kernel: " + json.dumps({
            "case": label, "sha256": digest,
            "ms": cs._time_ms(fn, iters=20 if wide else 100),
            "device_ms": cs._device_ms(fn, reps=10 if wide else 50)}),
            flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child()
        return 0
    this = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots = {"base": os.path.abspath(args.base), "this": this}
    got: dict[str, dict] = {"base": {}, "this": {}}
    for _ in range(args.repeat):
        for side in ORDER:
            env = dict(os.environ, PYTHONPATH=roots[side])
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child"],
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
    equal = {c: got["base"].get(c) == got["this"].get(c)
             and len(got["this"].get(c, ())) == 1 for c in CASES}
    print("ab: " + json.dumps({"bitwise_equal": equal}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
