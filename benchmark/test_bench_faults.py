"""A run with the timed path broken underneath comes out not correct
(CPU, at a small size, the cells' own limits): a step that returns its
state unchanged, half of each chunk's spectra left out, an answer altered
where it is produced, and on the ranks the exchange between the cards
left out.  The unbroken run comes out correct."""

import time

import pytest
import torch

from benchmark import compare, harness, spec, stream

pytest.importorskip("dc_sand_tpu_torch")

SEED = 2 ** 31 + 11


def _cell(name, **small):
    cs = spec.config(name)
    cfg = harness.chain_config(name, cs).replace(**small)
    return cfg, cs


# the smallest sizes at which a single flipped int8 value weighs well
# under the limits in a row (beam rows grow as antennas x channels)
SMALL = {"fx64": dict(n_ants=8, n_chans=512, spectra_per_chunk=32,
                      n_spectra_per_acc=128),
         "beam64": dict(n_ants=32, n_chans=1024, spectra_per_chunk=32)}


def _run(name, patch=None) -> bool:
    cfg, cs = _cell(name, **SMALL[name])
    out = stream.run_cell(cfg, cs, spec.traffic("stream"), SEED, 0.2, None,
                          "cpu", time.time(), patch=patch)
    return compare.judge(out["readings"], cs["check_limits"])[0]


def state_unchanged(runner):
    step = runner._step

    def frozen(history, acc, *rest):
        kept = [h.clone() for h in history], [a.clone() for a in acc]
        out = step(history, acc, *rest)
        for x, y in zip(history + acc, kept[0] + kept[1]):
            x.copy_(y)
        return out

    runner._step = frozen


def half_left_out(runner):
    step = runner._step

    def half(history, acc, chunks, *rest):
        cut = []
        for c in chunks:
            c = c.clone()
            c[:, c.shape[1] // 2:] = 0
            cut.append(c)
        return step(history, acc, cut, *rest)

    runner._step = half


def answer_altered(runner):
    if runner.mode == "fx":
        dump = runner._dump

        def altered(*args, **kw):
            runner.vis_acc[0][3, 0, 2] *= -1   # vr of antennas 0, 1, pol 0
            return dump(*args, **kw)

        runner._dump = altered
        return
    step = runner._step

    def altered_beam(*args):
        out = step(*args)
        v = out["beams"][0][0, 0, 5, 7, 0]
        v.copy_(-v - 1)                   # 8-bit or float, never itself
        return out

    runner._step = altered_beam


@pytest.mark.parametrize("name", ["fx64", "beam64"])
def test_unbroken_run_is_correct(name):
    assert _run(name)


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
@pytest.mark.parametrize("name", ["fx64", "beam64"])
def test_broken_run_is_not_correct(name, fault):
    assert not _run(name, fault)


def leave_out_exchange(runner):
    """Each shard keeps its own block of the corner-turn and receives
    nothing from the other cards."""
    from dc_sand_tpu_torch.models import pipeline
    from dc_sand_tpu_torch.parallel import FX_AXIS

    def own_only(qs, mesh, out=None):
        n = mesh.shape[FX_AXIS]
        k, c, s_l, b = qs[0].shape
        k_l = k // n
        res = []
        for q, d in zip(qs, mesh.local_shards):
            f = mesh.coords(d)[1]
            o = torch.zeros((k_l, c, n, s_l, b), dtype=q.dtype)
            o[:, :, f] = q[f * k_l:(f + 1) * k_l]
            res.append(o.reshape(k_l, c * n * s_l, b))
        return res

    pipeline.corner_turn_all_to_all = own_only


@pytest.mark.parametrize("patch", [None,
                                   "benchmark.test_bench_faults:"
                                   "leave_out_exchange"])
def test_ranks_without_their_exchange_are_not_correct(patch):
    from benchmark import mesh
    cfg, cs = _cell("fx64", **SMALL["fx64"])
    traffic = spec.traffic("mesh4")
    out = mesh.run_cell({"name": "fx64-mesh4"}, cfg, cs, traffic, SEED, 0.3,
                        None, time.time(), device="cpu", patch=patch)
    assert out["chunks"] >= traffic["ring_chunks"]
    assert compare.judge(out["readings"], cs["check_limits"])[0] == (
        patch is None)
