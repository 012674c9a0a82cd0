"""Full-precision float32 products, whatever the caller's TF32 setting.

``cv_tpu`` pins ``precision=HIGHEST`` on its small float32 products.  On
the card a float32 ``@`` runs in TF32 when the process asks for it
(``torch.backends.cuda.matmul.allow_tf32 = True`` or
``torch.set_float32_matmul_precision("high")``), which keeps 10 mantissa
bits.  The functions of the port that take a float32 product (the 3x3 pose
compositions, the SVD and eigen products, the solvers' normal matrices)
run under :func:`full_f32`: the matmul precision is set to ``"highest"``
for the call and the caller's setting is restored after it.  A call that
finds ``"highest"`` already set changes nothing, so nested calls cost one
read.  Float64 products and the CPU are not affected by the setting.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_f32_products():
    """Run the block with full-precision float32 matmuls (TF32 off), then
    restore the process's setting."""
    prev = torch.get_float32_matmul_precision()
    if prev == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def full_f32(fn):
    """Decorate ``fn`` to run inside :func:`full_f32_products`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32_products():
            return fn(*args, **kwargs)

    return wrapper
