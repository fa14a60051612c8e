"""Device and dtype policy of the port.

The card (CUDA) by default, with no CPU fallback: the CPU runs only
when a caller passes ``device='cpu'`` (the tests do; the CLIs take
``--device cpu``).  f32 by default and f64 when
``Params.use_f64`` asks for the validation mode.  Nothing here changes
torch's default dtype: every entry point takes an explicit ``device`` and
``dtype`` and creates its tensors with them.
"""

from __future__ import annotations

import torch

__all__ = ['pick_device', 'pick_dtype', 'pin_full_f32', 'resolve_device',
           'scalar', 'visible_devices']


def pick_device(device=None) -> torch.device:
    """``device`` if given, else CUDA.  Raises when CUDA is asked for,
    or no device is given, and torch sees no card: the port never falls
    back to the CPU unasked."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible to torch; pass "
                           "device='cpu' (--device cpu on the command line) "
                           "to run on the CPU")
    return dev


def resolve_device(device=None) -> torch.device:
    """:func:`pick_device` with a CUDA device given its index (the current
    card's when it names none), so that two names of one card compare
    equal.  Raises for a card index torch does not see."""
    dev = pick_device(device)
    if dev.type == 'cuda':
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ValueError('{} is not a visible card: torch sees {}'.format(
                dev, torch.cuda.device_count()))
    return dev


def visible_devices(device=None) -> list:
    """The devices a default mesh spans, the port's ``jax.devices()``:
    every visible card on CUDA (the default), only the CPU with
    ``device='cpu'``.  The command lines build a mesh over them when there
    is more than one."""
    dev = pick_device(device)
    if dev.type == 'cuda':
        return [torch.device('cuda', i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def pick_dtype(params=None, dtype=None) -> torch.dtype:
    """``dtype`` if given, else f64 when ``params.use_f64`` is set, else
    f32."""
    if dtype is not None:
        return dtype
    return torch.float64 if getattr(params, 'use_f64', False) else torch.float32


def pin_full_f32():
    """Keep f32 products in full f32 (no TF32).  The JAX reference pins
    ``Precision.HIGHEST`` on this path (models/solver.py:292-293)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def scalar(x, dtype, device) -> torch.Tensor:
    """A 0-d tensor of ``x`` on ``device``.  Python numbers go through
    ``torch.full`` (a fill kernel), not ``torch.tensor`` (a blocking host
    copy), so building one inside the day loop never waits on the card."""
    if torch.is_tensor(x):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)
