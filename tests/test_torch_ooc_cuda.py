"""The out-of-core stream on the CUDA card (marked `cuda`; they skip
elsewhere): the round loop never synchronizes the whole device, a pinned
buffer and its device twin are rewritten only behind the event of the
fold that read them (a fold held back on the device still reads its own
tile), every round launches kernel B1 once, and the card's ooc solve
meets the CPU's within the whole-solve contract. Imports neither jax
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_ooc_cuda.py
"""

import numpy as np
import pytest
import torch

from dpsvm_tpu_torch import SVMConfig, solve
from dpsvm_tpu_torch.data.synth import make_blobs_binary
from dpsvm_tpu_torch.ops.subproblem import solve_subproblem
from dpsvm_tpu_torch.solver import ooc as tooc

CFG = SVMConfig(c=1.0, epsilon=1e-2, engine="block", working_set_size=64,
                max_iter=50_000, ooc=True, ooc_tile_rows=512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ooc stream's pinned "
                    "buffers, side stream and events are CUDA only")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data():
    return make_blobs_binary(n=3000, d=24, seed=11, sep=1.5)


@pytest.mark.cuda
def test_ooc_round_loop_never_synchronizes_the_device(cuda, data,
                                                      monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("device-wide synchronize in the ooc solve")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    res = solve(*data, CFG.replace(ooc_cache_lines=256))
    assert res.converged and res.stats["tiles_streamed"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pinned_buffers_are_reused_only_behind_their_events(cuda, dtype,
                                                            monkeypatch):
    """Each consumer step queues a long device-side spin before it reads
    its tile, so an early rewrite of either buffer would be read by the
    held-back fold; every tile read must be host X's rows (rounded to
    the storage dtype on the card), and each restage waits on the
    event of the fold that last read the slot."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 40)).astype(np.float32)
    waited = []
    sync = torch.cuda.Event.synchronize

    def spy(ev):
        waited.append(ev)
        return sync(ev)

    monkeypatch.setattr(torch.cuda.Event, "synchronize", spy)
    st = tooc.TileStream(x, 1000, 40, 128, cuda, dtype)
    order = [3, 0, 7, 1, 5, 2, 6, 4, 0]
    seen = []
    for i, xt, rows in st.walk(order):
        torch.cuda._sleep(2_000_000)
        seen.append((i, xt.clone()))
    want_dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for i, got in seen:
        want = torch.from_numpy(x[i * 128:i * 128 + st.rows(i)]).to(want_dt)
        assert torch.equal(got.cpu(), want), f"tile {i} was overwritten"
    # The first two stages find their slots fresh; every later one waits.
    assert len(waited) == len(order) - 2
    assert st.bytes == sum(st.rows(i) for i in order) * 40 * 4


@pytest.mark.cuda
def test_card_ooc_launches_b1_each_round_and_meets_the_cpu(cuda, data):
    x, y = data
    solve_subproblem.launches = 0
    res = solve(x, y, CFG)
    assert solve_subproblem.launches == res.stats["outer_rounds"] > 0
    cpu = solve(x, y, CFG, device="cpu")
    assert res.converged and cpu.converged
    assert abs(res.n_sv - cpu.n_sv) <= max(1, 0.02 * cpu.n_sv)
    assert abs(res.b - cpu.b) <= 5e-3
    incore = solve(x, y, CFG.replace(ooc=False, ooc_tile_rows=8192))
    assert abs(res.n_sv - incore.n_sv) <= max(1, 0.02 * incore.n_sv)
