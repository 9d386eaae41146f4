"""The port's pipeline timetable (parallel/pipeline.py `timetable`) with no
process group, and its stacked-leaf layouts against the reference's.

For pp 2 and 4, vpp 1 and 2, n_micro 1-9 and both schedules, a walk over
every stage's ticks checks that every (microbatch, chunk) is forwarded
once and then backwarded once, that each unit's input (the intake, a
boundary tensor received, or the head's cotangent) is there before the
unit runs, that each receive meets its send in the same tick, and that
1F1B holds at most 2P - 1 microbatches in flight per chunk, whatever
n_micro (P = pp*vpp). Exact checks: no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from megatron_tpu.parallel import pipeline as jpl
from megatron_tpu_torch.parallel import pipeline as pl
from megatron_tpu_torch.parallel.sharding import stage_layers

CASES = [(pp, vpp) for pp in (2, 4) for vpp in (1, 2)]


def walk(pp, vpp, n_micro, schedule):
    """Simulate every stage tick by tick; returns (ticks, the largest
    count of microbatches in flight on one chunk)."""
    table = pl.timetable(pp, vpp, n_micro, schedule)
    T = len(table[0])
    assert all(len(col) == T for col in table)
    P = pp * vpp
    done_f, done_b, inbox = set(), set(), set()
    head_ct = set()
    flight = [[0] * vpp for _ in range(pp)]
    peak = 0
    for t in range(T):
        delivered = set()
        for s in range(pp):
            tick = table[s][t]
            produced = set()
            for c, m in tick.fwd:
                pos = c * pp + s
                assert (pos, m) not in done_f
                if pos > 0:
                    assert ("act", pos, m) in inbox, (s, t, c, m)
                    inbox.discard(("act", pos, m))
                done_f.add((pos, m))
                flight[s][c] += 1
                peak = max(peak, flight[s][c])
                if pos < P - 1:
                    produced.add(("act", pos + 1, m))
                else:
                    head_ct.add(m)
            for c, m in tick.bwd:
                pos = c * pp + s
                assert (pos, m) in done_f and (pos, m) not in done_b
                if pos == P - 1:
                    assert m in head_ct
                else:
                    assert ("grad", pos, m) in inbox, (s, t, c, m)
                    inbox.discard(("grad", pos, m))
                done_b.add((pos, m))
                flight[s][c] -= 1
                if pos > 0:
                    produced.add(("grad", pos - 1, m))
            assert {k for k, _ in tick.sends} == produced
            for key, dst in tick.sends:
                # the receiver lists the same message, from this stage,
                # in the same tick
                assert (key, s) in table[dst][t].recvs
                delivered.add(key)
            for key, src in tick.recvs:
                assert (key, s) in table[src][t].sends
        inbox |= delivered
    want = {(pos, m) for pos in range(P) for m in range(n_micro)}
    assert done_f == want and done_b == want and not inbox
    return T, peak


@pytest.mark.parametrize("pp,vpp", CASES)
def test_1f1b_timetable(pp, vpp):
    P = pp * vpp
    for n_micro in range(1, 10):
        T, peak = walk(pp, vpp, n_micro, "1f1b")
        assert T == n_micro + 2 * (P - 1)
        assert peak <= 2 * P - 1
        assert pl.bubble_fraction(n_micro, pp, vpp) == 2 * (P - 1) / T


@pytest.mark.parametrize("pp,vpp", CASES)
def test_gpipe_timetable(pp, vpp):
    P = pp * vpp
    for n_micro in range(1, 10):
        T, peak = walk(pp, vpp, n_micro, "gpipe")
        assert T == 2 * (n_micro + P - 1)
        assert peak == n_micro  # fill-drain keeps every microbatch
        fwd = pl.timetable(pp, vpp, n_micro, "gpipe", "fwd")
        assert len(fwd[0]) == n_micro + P - 1
        assert all(not t.bwd for col in fwd for t in col)


def test_timetable_refusals():
    with pytest.raises(ValueError, match="pipeline_schedule"):
        pl.timetable(2, 1, 4, "interleaved")
    with pytest.raises(ValueError, match="phase"):
        pl.timetable(2, 1, 4, "1f1b", "fwd")
    with pytest.raises(ValueError, match="microbatch"):
        pl.timetable(2, 1, 0)


@pytest.mark.parametrize("pp,vpp", [(2, 1), (2, 2), (4, 1), (2, 3)])
def test_stage_layouts_match_reference(pp, vpp):
    """The four stage_params_* functions equal the reference's bit for bit
    on a stacked leaf of 12 layers, and sharding's stage_layers names the
    rows the reference's chunked layout gives each stage."""
    x = np.random.RandomState(0).randn(12, 3, 2).astype(np.float32)
    t = torch.from_numpy(x)
    ch = pl.stage_params_chunked({"w": t}, pp, vpp)["w"]
    want = np.asarray(jpl.stage_params_chunked({"w": jnp.asarray(x)}, pp,
                                               vpp)["w"])
    np.testing.assert_array_equal(ch.numpy(), want)
    np.testing.assert_array_equal(pl.stage_params_unchunk(ch).numpy(), x)
    np.testing.assert_array_equal(
        pl.stage_params_unchunk(ch).numpy(),
        np.asarray(jpl.stage_params_unchunk(jnp.asarray(want))))
    rs = pl.stage_params_reshape(t, pp)
    np.testing.assert_array_equal(
        rs.numpy(), np.asarray(jpl.stage_params_reshape(jnp.asarray(x), pp)))
    np.testing.assert_array_equal(pl.stage_params_flatten(rs).numpy(), x)
    np.testing.assert_array_equal(
        pl.stage_params_flatten(rs).numpy(),
        np.asarray(jpl.stage_params_flatten(jnp.asarray(rs.numpy()))))
    for s in range(pp):
        rows = stage_layers(12, pp, vpp, s)
        np.testing.assert_array_equal(x[rows], want[s].reshape(-1, 3, 2))
