"""Wrapper of the LOCF kernel (``csrc/locf.cu``).

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
one of the kernel's two instances, chosen by :func:`impl_for` (``"row"``
for T <= 16, ``"warp"`` above; see ``kernels/rows.py``), or raises.
``LAUNCHES`` counts kernel launches, ``LAUNCHES_BY_IMPL`` the same per
instance.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.locf.ref import locf_ref
from repro_torch.kernels.rows import IMPLS, aligned, impl_for

LAUNCHES = 0
LAUNCHES_BY_IMPL = {"row": 0, "warp": 0}


def locf(values, observed, init_value, init_has):
    """Batched entry: values/observed (E, S, T), carry-in
    init_value/init_has (E, S). Values of any dtype are read as float32
    and masks as ``> 0`` after a float32 cast, as the reference's entry
    reads them. Returns (filled float32, has bool), both (E, S, T)."""
    global LAUNCHES
    values, init_value = map(_build.as_float32, (values, init_value))
    observed, init_has = map(_build.as_mask, (observed, init_has))
    E, S, T = values.shape
    dev = values.device
    _build.require("values", values, torch.float32, (E, S, T), dev)
    _build.require("observed", observed, torch.bool, (E, S, T), dev)
    _build.require("init_value", init_value, torch.float32, (E, S), dev)
    _build.require("init_has", init_has, torch.bool, (E, S), dev)
    R = E * S
    if dev.type == "cpu":
        out, has = locf_ref(values.reshape(R, T), observed.reshape(R, T),
                            init_value.reshape(R), init_has.reshape(R))
        return out.reshape(E, S, T), has.reshape(E, S, T)
    if dev.type != "cuda":
        raise ValueError(f"locf: no kernel for device {dev}")
    if R * T >= 2 ** 31:
        raise ValueError(f"locf: R*T = {R * T} elements; the kernel "
                         "indexes in 32 bits (< 2^31)")
    lib = _build.library()
    out = torch.empty_like(values)
    has = torch.empty_like(observed)
    impl, vec = impl_for(T, aligned(values, observed, out, has))
    with _build.on_device(dev):
        _build.check(lib.locf_launch(
            values.data_ptr(), observed.data_ptr(), init_value.data_ptr(),
            init_has.data_ptr(), out.data_ptr(), has.data_ptr(), R, T,
            IMPLS[impl], int(vec), _build.stream_ptr(dev)), f"locf ({impl})")
    LAUNCHES += 1
    LAUNCHES_BY_IMPL[impl] += 1
    return out, has
