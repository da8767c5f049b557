"""Working-set set definitions for modified SMO (counterpart of
dpsvm_tpu/ops/select.py).

  I_up  = {y=+1, a<C} u {y=-1, a>0}
  I_low = {y=+1, a>0} u {y=-1, a<C}

b_hi = min f over I_up, b_lo = max f over I_low; converged when
b_lo <= b_hi + 2 eps. Ties resolve to the lowest index, as in the JAX
package (torch.argmin/argmax return the first extremum).
"""

from __future__ import annotations

import numpy as np
import torch

_INF = float("inf")


def split_c(c) -> tuple:
    """Normalize a scalar-or-(c_pos, c_neg) box bound to the pair form."""
    return c if isinstance(c, tuple) else (c, c)


def c_of(y: torch.Tensor, c_pos: float, c_neg: float):
    """Per-row upper bound C_i = C * w_{y_i}; the plain scalar when the
    class weights are equal (so the comparisons see the same float32
    constant the JAX package compiles)."""
    if c_pos == c_neg:
        return c_pos
    return torch.where(y > 0, c_pos, c_neg)


def up_mask(alpha: torch.Tensor, y: torch.Tensor, c_pos: float,
            c_neg: float | None = None) -> torch.Tensor:
    """Membership in I_up."""
    c = c_of(y, c_pos, c_pos if c_neg is None else c_neg)
    return torch.where(y > 0, alpha < c, alpha > 0)


def low_mask(alpha: torch.Tensor, y: torch.Tensor, c_pos: float,
             c_neg: float | None = None) -> torch.Tensor:
    """Membership in I_low."""
    c = c_of(y, c_pos, c_pos if c_neg is None else c_neg)
    return torch.where(y > 0, alpha > 0, alpha < c)


def order_key(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 whose signed order is the float total order
    (-0.0 below +0.0, as lax.top_k and XLA's min / max see it). The map
    is its own inverse: ``from_order_key`` undoes it."""
    bits = v.contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def from_order_key(k: torch.Tensor) -> torch.Tensor:
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def ieee_max(v: torch.Tensor) -> torch.Tensor:
    """max(v) as XLA reduces it: a +-0 tie gives +0.0 whatever the order
    (torch.amax keeps whichever zero it meets first). NaN unsupported."""
    return from_order_key(order_key(v).amax())


def set_masks(alpha, y, c, valid=None) -> tuple:
    """(up, low): membership in I_up and I_low; `valid` (bool) masks
    padded rows out of both."""
    cp, cn = split_c(c)
    up = up_mask(alpha, y, cp, cn)
    low = low_mask(alpha, y, cp, cn)
    if valid is not None:
        up = up & valid
        low = low & valid
    return up, low


def select_working_set(f, alpha, y, c, valid=None) -> tuple:
    """The maximal violating pair (i_up, b_hi, i_low, b_lo) as 0-d
    tensors (int64 ids, float32 values). Ties go to the lowest index;
    each value is the element at its index (f_up[i_up]), not an IEEE
    min, as in the JAX package."""
    up, low = set_masks(alpha, y, c, valid)
    f = f.float()
    f_up = torch.where(up, f, _INF)
    f_low = torch.where(low, f, -_INF)
    i_up = torch.argmin(f_up)
    i_low = torch.argmax(f_low)
    return i_up, take(f_up, i_up), i_low, take(f_low, i_low)


def select_working_set_batched(f, alpha, y, c_pos, c_neg, valid=None):
    """The maximal violating pair of each problem of a (k, n) stack (the
    fleet, solver/fleet.py) in one masked pass: f, alpha, y and valid
    (bool: padding and each problem's rows) are (k, n); c_pos, c_neg
    (k, 1) per-problem box bounds. Returns (i_hi, b_hi, i_lo, b_lo),
    each (k,): int64 ids, float32 values. Ties and values as
    select_working_set's (lowest index; the element at its index). The
    per-row bound is always materialized, since the bounds are
    per-problem tensors."""
    f = f.float()
    pos = y > 0
    c_row = torch.where(pos, c_pos, c_neg)
    up = torch.where(pos, alpha < c_row, alpha > 0)
    low = torch.where(pos, alpha > 0, alpha < c_row)
    if valid is not None:
        up = up & valid
        low = low & valid
    f_up = torch.where(up, f, _INF)
    f_low = torch.where(low, f, -_INF)
    i_hi = torch.argmin(f_up, dim=1)
    i_lo = torch.argmax(f_low, dim=1)
    return (i_hi, torch.gather(f_up, 1, i_hi[:, None])[:, 0],
            i_lo, torch.gather(f_low, 1, i_lo[:, None])[:, 0])


def take(v: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """v[i] for a 0-d index tensor, as a 0-d tensor gathered on the
    device (indexing with a 0-d tensor may read it on the host)."""
    return v.index_select(0, i.reshape(1)).reshape(())


def candidate_live_mask(alpha_w, y_w, c) -> torch.Tensor:
    """Handoff gate of the pipelined block rounds: a working set picked
    from the pre-fold gradient keeps a slot live only while its point is
    still in I_up or I_low under the CURRENT alpha (a candidate the
    previous round saturated out of both sets is masked, not replaced)."""
    cp, cn = split_c(c)
    return up_mask(alpha_w, y_w, cp, cn) | low_mask(alpha_w, y_w, cp, cn)


def nu_stopping_pair(bh_p, bl_p, bh_n, bl_n):
    """LibSVM's nu stopping gap: the per-class (b_hi, b_lo) of the class
    with the larger violation, so b_lo - b_hi == max(violation_+,
    violation_-). The test (bl_p - bh_p) >= (bl_n - bh_n) is float32
    arithmetic on tensors (an empty class gives -inf there; ties go to
    the + class) and float64 on Python floats, as in the JAX package."""
    if torch.is_tensor(bh_p):
        take_p = (bl_p - bh_p) >= (bl_n - bh_n)
        return (torch.where(take_p, bh_p, bh_n),
                torch.where(take_p, bl_p, bl_n))
    take_p = (bl_p - bh_p) >= (bl_n - bh_n)
    return (bh_p, bl_p) if take_p else (bh_n, bl_n)


def select_working_set_nu(f, alpha, y, c, valid=None) -> tuple:
    """The nu duals' pair (i_up, b_hi, i_low, b_lo): the maximal
    violating pair inside {y=+1} and inside {y=-1}, and of those the
    class with the larger violation (the duals carry one equality
    constraint per class, so a pair must share a class). Ties and values
    as select_working_set's."""
    up, low = set_masks(alpha, y, c, valid)
    f = f.float()
    pos = y > 0

    def class_pair(cls):
        f_up = torch.where(up & cls, f, _INF)
        f_low = torch.where(low & cls, f, -_INF)
        i_up = torch.argmin(f_up)
        i_low = torch.argmax(f_low)
        return i_up, take(f_up, i_up), i_low, take(f_low, i_low)

    iu_p, bh_p, il_p, bl_p = class_pair(pos)
    iu_n, bh_n, il_n, bl_n = class_pair(~pos)
    take_p = (bl_p - bh_p) >= (bl_n - bh_n)
    return (torch.where(take_p, iu_p, iu_n), torch.where(take_p, bh_p, bh_n),
            torch.where(take_p, il_p, il_n), torch.where(take_p, bl_p, bl_n))


def stopping_extrema(f, alpha, y, c, valid=None, rule: str = "mvp"):
    """Device-side (b_hi, b_lo) of the current state as 0-d float32
    tensors (the C-SVC rules share the stopping extrema; "nu" takes the
    per-class pair through nu_stopping_pair)."""
    f = f.float()
    up, low = set_masks(alpha, y, c, valid)
    if rule == "nu":
        pos = y > 0
        return nu_stopping_pair(
            torch.where(up & pos, f, _INF).min(),
            torch.where(low & pos, f, -_INF).max(),
            torch.where(up & ~pos, f, _INF).min(),
            torch.where(low & ~pos, f, -_INF).max())
    return (torch.where(up, f, _INF).min(),
            torch.where(low, f, -_INF).max())


def extrema_np(f, alpha, y, c, rule: str = "mvp"):
    """Host-side (NumPy) stopping extrema (b_hi, b_lo) of a final state,
    as Python floats. A float64 f is kept as is."""
    cp, cn = split_c(c)
    f = np.asarray(f)
    if f.dtype != np.float64:
        f = f.astype(np.float32)
    alpha = np.asarray(alpha)
    y = np.asarray(y)
    c_row = cp if cp == cn else np.where(y > 0, cp, cn)
    up = np.where(y > 0, alpha < c_row, alpha > 0)
    low = np.where(y > 0, alpha > 0, alpha < c_row)

    def pair(u, lo):
        return (float(np.min(np.where(u, f, np.inf))),
                float(np.max(np.where(lo, f, -np.inf))))

    if rule != "nu":
        return pair(up, low)
    pos = y > 0
    return nu_stopping_pair(*pair(up & pos, low & pos),
                            *pair(up & ~pos, low & ~pos))


def refresh_extrema_host(f, alpha, y, c, epsilon: float, rule: str = "mvp"):
    """Budget-exit refresh: the block engine's carried extrema are one
    fold behind when the loop exits on the pair budget, so recompute
    (b_hi, b_lo, converged) exactly from the pulled final state."""
    b_hi, b_lo = extrema_np(f, alpha, y, c, rule)
    return b_hi, b_lo, not (b_lo > b_hi + 2.0 * epsilon)


def shrink_view(w, slot_ok, n: int, n_pad: int, tile: int):
    """The host-side active view of a shrink cycle (the ooc shrunken
    stream, solver/ooc.py). `w` / `slot_ok` are the pulled (m,) outputs
    of a select_block with q = m: the m most-violating rows. Returns
    (active, live_tiles): an (n_pad,) bool mask over the selected REAL
    rows (dead slots and ids past n dropped) and the sorted unique
    indices of the `tile`-row stream tiles the view intersects, the only
    tiles an in-cycle round streams."""
    ids = np.asarray(w)[np.asarray(slot_ok, bool)]
    ids = ids[(ids >= 0) & (ids < n)]
    active = np.zeros((n_pad,), bool)
    active[ids] = True
    return active, np.unique(ids // tile)
