"""The port's xDeepFM serving path against ``repro``'s, on the smoke config
with the reference's parameters carried across by ``params_from_numpy``
and the same ``ClickStream`` batches.

Tolerance: 1e-5 absolute plus 1e-5 relative in fp32.  Both sides compute
the same float32 math; the CPU matmuls and segment sums only sum in
another order, which moves a value by a few units in its last place (the
largest gap measured here is below 1e-6).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.synthetic import ClickStream as JClickStream
from repro.launch import serve as jserve
from repro.models import recsys as jr
from repro_torch.configs import get_config
from repro_torch.data.synthetic import ClickStream
from repro_torch.kernels import cin, segment_matmul
from repro_torch.launch import serve as tserve
from repro_torch.models import recsys as tr

TOL = 1e-5
CFG = jget("xdeepfm").smoke


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    jp = jr.init_params(CFG, jax.random.PRNGKey(0))
    return jp, tr.params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _batches(n=16, seed=3):
    nb = ClickStream(CFG, n, seed=seed).next()
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            tr.batch_to_torch(nb, "cpu"))


def _close(got, exp, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


def test_config_and_click_stream_equal_reference():
    a, b = jget("xdeepfm"), get_config("xdeepfm")
    assert dataclasses.asdict(a.model) == dataclasses.asdict(b.model)
    assert dataclasses.asdict(a.smoke) == dataclasses.asdict(b.smoke)
    assert a.shapes == b.shapes and a.family == b.family == "recsys"
    for cfg in (a.model, a.smoke):
        js, ts = JClickStream(cfg, 7, seed=5), ClickStream(cfg, 7, seed=5)
        for _ in range(2):
            jb, tb = js.next(), ts.next()
            assert jb.keys() == tb.keys()
            for k in jb:
                assert jb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(jb[k], tb[k])
        assert js.state_dict() == ts.state_dict()


def test_params_round_trip(carried):
    jp, tp = carried
    tree = jax.tree.map(np.asarray, jp)
    back = tr.params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    fresh = tr.init_params(CFG, torch.Generator().manual_seed(0))
    assert jax.tree.structure(tr.params_to_numpy(fresh)) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tr.params_to_numpy(fresh)),
                    jax.tree.leaves(tree)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(carried, mode):
    jp, tp = carried
    rng = np.random.default_rng(2)
    rows = rng.integers(0, tp["table"].shape[0], 40).astype(np.int32)
    bags = np.sort(rng.integers(0, 9, 40)).astype(np.int32)   # bag 9: empty
    exp = jr.embedding_bag(jp["table"], jnp.asarray(rows), jnp.asarray(bags),
                           10, mode=mode)
    n = segment_matmul.LAUNCHES
    got = tr.embedding_bag(tp["table"], torch.from_numpy(rows),
                           torch.from_numpy(bags), 10, mode=mode)
    assert segment_matmul.LAUNCHES == n
    _close(got, exp)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_on_declared_sorted_ids_matches_reference(carried,
                                                                 mode):
    jp, tp = carried
    rng = np.random.default_rng(5)
    rows = rng.integers(-50, tp["table"].shape[0], 64).astype(np.int32)
    bags = np.sort(rng.integers(-1, 13, 64)).astype(np.int32)  # some outside
    exp = jr.embedding_bag(jp["table"], jnp.asarray(rows), jnp.asarray(bags),
                           12, mode=mode)
    got = tr.embedding_bag(tp["table"], torch.from_numpy(rows),
                           torch.from_numpy(bags), 12, mode=mode,
                           ids_sorted=True)
    _close(got, exp, 1e-6)


def test_multihot_bags_are_field_major_and_sorted():
    """``multihot_bags`` orders bags field-major (bag f·B + b) with ids
    ascending; each bag holds the rows of the reference's bag (b, f)."""
    _, tb = _batches(5, seed=8)
    rows, bags = tr.multihot_bags(CFG, tb["multihot_ids"])
    b, f, bag = tb["multihot_ids"].shape
    assert rows.dtype == bags.dtype == torch.int32 and rows.is_contiguous()
    assert bool((bags[1:] >= bags[:-1]).all())
    ref_rows = tr._field_rows(CFG, tb["multihot_ids"], CFG.n_sparse - f)
    for k in range(f * b):
        np.testing.assert_array_equal(rows[bags == k].numpy(),
                                      ref_rows[k % b, k // b].numpy())


def test_field_embeddings_make_one_declared_sorted_mean_call(carried,
                                                             monkeypatch):
    """The multi-hot fields are one K4 call: bag ids declared sorted (no
    sort on the card) and the mean fused (no rows-entry count call)."""
    _, tp = carried
    _, tb = _batches(4, seed=2)
    seen = []
    gathered = tr.kernel_ops.segment_matmul_gathered

    def spy(*args, **kw):
        seen.append(kw)
        return gathered(*args, **kw)

    monkeypatch.setattr(tr.kernel_ops, "segment_matmul_gathered", spy)
    monkeypatch.setattr(tr.kernel_ops, "segment_matmul", None)
    tr._field_embeddings(CFG, tp, tb)
    assert seen == [{"ids_sorted": True, "mean": True}]


def test_field_embeddings_and_cin_match_reference(carried):
    jp, tp = carried
    jb, tb = _batches()
    emb = jr._field_embeddings(CFG, jp, jb)
    got = tr._field_embeddings(CFG, tp, tb)
    assert got.shape == (16, CFG.n_sparse + 1, CFG.embed_dim)
    _close(got, emb)
    n = cin.LAUNCHES
    _close(tr._cin(tp, got), jr._cin(jp, emb))
    assert cin.LAUNCHES == n


def test_forward_serve_and_loss_match_reference(carried):
    jp, tp = carried
    jb, tb = _batches(32, seed=4)
    _close(tr.forward(CFG, tp, tb), jr.forward(CFG, jp, jb))
    scores = tr.serve(CFG, tp, tb)
    assert scores.shape == (32,) and bool(torch.isfinite(scores).all())
    _close(scores, jr.serve(CFG, jp, jb))
    _close(tr.loss_fn(CFG, tp, tb), jr.loss_fn(CFG, jp, jb))


def test_retrieval_score_matches_reference(carried):
    """Scores within tolerance; the chosen candidates equal wherever the
    gap to the next score exceeds it."""
    jp, tp = carried
    jb, tb = _batches(1, seed=6)
    cand = np.arange(CFG.vocab_per_field, dtype=np.int32)
    jb["candidate_ids"] = jnp.asarray(cand)
    tb["candidate_ids"] = torch.from_numpy(cand)
    js, ji = jr.retrieval_score(CFG, jp, jb, top_k=20)
    ts, ti = tr.retrieval_score(CFG, tp, tb, top_k=20)
    _close(ts, js)
    js, ji = np.asarray(js), np.asarray(ji)
    gaps = np.abs(np.diff(js))
    clear = np.ones(20, bool)
    clear[:-1] &= gaps > TOL
    clear[1:] &= gaps > TOL
    assert clear.sum() >= 10
    np.testing.assert_array_equal(ti.numpy()[clear], ji[clear])


def test_serve_launcher_matches_reference(carried, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch xdeepfm --device cpu``
    on the reference's seeded parameters gives the reference launcher's
    scores and mean CTR."""
    jp, tp = carried
    exp = jserve.main(["--arch", "xdeepfm"])
    ref_line = capsys.readouterr().out.strip()
    monkeypatch.setattr(tserve.recsys, "init_params", lambda cfg, gen: tp)
    got = tserve.main(["--arch", "xdeepfm", "--device", "cpu"])
    line = capsys.readouterr().out.strip()
    _close(got, exp)
    assert line.startswith(ref_line) and line.endswith("on cpu"), (line, ref_line)
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "gcn-cora", "--device", "cpu"])
