"""Record what a model's functional ops return, call by call.

``record_calls(module, names)`` wraps the module-level functions ``names``
of ``module`` (e.g. ``dense``, ``layer_norm``, ``flash_attention`` of
``feddrift_torch.models.transformer``) for the span of a ``with`` block and
collects ``(label, output)`` in call order; the label is the function's
name and, where its third argument is a layer name, that name. Comparing
two such records of the same rows locates the first op whose answer
depends on something else than the row, such as the size of the batch it
was computed in. A diagnostic: nothing on a hot path uses it.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def record_calls(module, names):
    calls: list[tuple[str, object]] = []
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            layer = args[2] if len(args) > 2 and isinstance(args[2], str) \
                else None
            calls.append((f"{name}({layer})" if layer else name, out))
            return out
        return inner

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def first_difference(a, b, row: int = 0):
    """Per op of two records of the same calls: the max |difference| of
    ``row`` in each output, and the label of the first op whose row
    differs bitwise (None when every op agrees)."""
    if [n for n, _ in a] != [n for n, _ in b]:
        raise ValueError("the two records ran different ops")
    diffs, first = [], None
    for i, ((name, x), (_, y)) in enumerate(zip(a, b)):
        d = float((x[row] - y[row]).abs().max())
        label = f"{i}:{name}"
        diffs.append((label, d))
        if first is None and not bool((x[row] == y[row]).all()):
            first = label
    return diffs, first
