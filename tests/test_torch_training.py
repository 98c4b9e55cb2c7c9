"""The port's training substrate against ``repro``'s: AdamW, schedules,
clipping, the straggler monitor, int8 compression (with error feedback and
as a psum over a ``ShardMesh``), the async checkpointer, the loop's
restart, checkpoints crossing packages, the GNN launcher, and the
truss-filtered GCN loop of ``examples/evolving_graph_training.py``.

Tolerances: optimizer arithmetic within rtol 1e-6 plus atol 1e-7 (the
same float32 operations in the same order; XLA may fuse them); losses of
trained models within rtol 1e-4 plus atol 1e-6 (each step's float32
gradients differ from the reference's in their last places, and AdamW
carries that into the next step's parameters).  Restarts within the port
are bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import DynamicGraph as JDynamicGraph
from repro.data import sampler as jsampler
from repro.data.streams import GraphUpdateStream as JGraphUpdateStream
from repro.data.synthetic import powerlaw_graph as jpowerlaw_graph
from repro.launch import train as jtrain
from repro.models import gnn as jgnn
from repro.training import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import loop as jloop
from repro.training import optimizer as jopt
from repro_torch.core import DynamicGraph
from repro_torch.data import sampler
from repro_torch.data.streams import GraphUpdateStream
from repro_torch.data.synthetic import TokenStream, powerlaw_graph
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.models import gnn
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression
from repro_torch.training import loop
from repro_torch.training import optimizer as opt
from repro_torch.training.optimizer import tree_leaves

OPT_RTOL, OPT_ATOL = 1e-6, 1e-7
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in
    several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {"b": [rng.normal(size=(3,)).astype(np.float32) * scale,
                  rng.normal(size=(2, 2)).astype(np.float32) * scale],
            "a": rng.normal(size=(4, 5)).astype(np.float32) * scale}


def _torch(tree):
    return opt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_trees(got, exp, rtol=OPT_RTOL, atol=OPT_ATOL):
    gl, el = tree_leaves(got), jax.tree.leaves(exp)
    assert len(gl) == len(el)
    for g, e in zip(gl, el):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e), rtol=rtol,
                                   atol=atol)


# ---------------------------------------------------------------------------
# optimizer and compression against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_value_matches_reference(schedule):
    cfg = opt.AdamWConfig(lr=0.3, warmup_steps=7, total_steps=50,
                          schedule=schedule)
    jcfg = jopt.AdamWConfig(lr=0.3, warmup_steps=7, total_steps=50,
                            schedule=schedule)
    for s in (0, 1, 6, 7, 8, 20, 49, 50, 60):
        got = opt.schedule_value(cfg, torch.tensor(s, dtype=torch.int32))
        exp = jopt.schedule_value(jcfg, jnp.int32(s))
        np.testing.assert_allclose(float(got), float(exp), rtol=OPT_RTOL,
                                   atol=OPT_ATOL, err_msg=f"step {s}")


@pytest.mark.parametrize("steps,clip", [(1, 1.0), (5, 1.0), (5, None)])
def test_adamw_update_matches_reference(steps, clip):
    rng = np.random.default_rng(steps)
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, clip_norm=clip)
    cfg, jcfg = opt.AdamWConfig(**kw), jopt.AdamWConfig(**kw)
    p0 = _tree(rng)
    tp, jp = _torch(p0), jax.tree.map(jnp.asarray, p0)
    ts, js = opt.adamw_init(tp), jopt.adamw_init(jp)
    assert sorted(ts) == sorted(js) and ts["step"].dtype == torch.int32
    for _ in range(steps):
        g = _tree(rng, scale=3.0)
        tp, ts, tstats = opt.adamw_update(cfg, _torch(g), ts, tp)
        jp, js, jstats = jopt.adamw_update(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                       rtol=OPT_RTOL, atol=OPT_ATOL)
    _close_trees(tp, jp)
    _close_trees(ts["mu"], js["mu"])
    _close_trees(ts["nu"], js["nu"])
    assert int(ts["step"]) == int(js["step"]) == steps
    np.testing.assert_array_equal(
        tree_leaves(opt.sgd_update(0.1, _torch(p0), _torch(p0)))[0].numpy(),
        np.asarray(jax.tree.leaves(jopt.sgd_update(
            0.1, jax.tree.map(jnp.asarray, p0), jax.tree.map(jnp.asarray, p0)))[0]))


def test_clip_by_global_norm_matches_reference():
    for scale in (0.01, 1.0, 50.0):
        t = _tree(np.random.default_rng(3), scale)
        got, gn = opt.clip_by_global_norm(_torch(t), 1.0)
        exp, jgn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, t), 1.0)
        np.testing.assert_allclose(float(gn), float(jgn), rtol=OPT_RTOL)
        _close_trees(got, exp)
    got, gn = opt.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 1.0)
    assert abs(float(gn) - 5.0) < 1e-6
    np.testing.assert_allclose(got["a"].numpy(), [0.6, 0.8], rtol=1e-6)


def test_straggler_monitor_matches_reference():
    dts = [0.1, 0.11, 0.09, 1.0, 0.1, 0.5, 0.12, 0.4, 0.1]
    m = loop.StragglerMonitor(factor=3.0, alpha=0.5)
    jm = jloop.StragglerMonitor(factor=3.0, alpha=0.5)
    for i, dt in enumerate(dts):
        assert m.observe(i, dt) == jm.observe(i, dt)
    assert m.flagged == jm.flagged and m.flagged[0][0] == 3
    assert m.ewma == jm.ewma


def test_compress_with_error_feedback_matches_reference():
    rng = np.random.default_rng(0)
    first = _tree(rng)
    res, jres = compression.ef_init(_torch(first)), jcomp.ef_init(first)
    for _ in range(6):
        g = _tree(rng, scale=2.0)
        dec, res = compression.compress_with_error_feedback(_torch(g), res)
        jdec, jres = jcomp.compress_with_error_feedback(
            jax.tree.map(jnp.asarray, g), jres)
        _close_trees(dec, jdec)
        _close_trees(res, jres)
    x = torch.from_numpy(rng.normal(size=(50,)).astype(np.float32))
    q, s = compression.quantize_int8(x)
    jq, js = jcomp.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=OPT_RTOL)
    np.testing.assert_allclose(compression.dequantize_int8(q, s).numpy(),
                               np.asarray(jcomp.dequantize_int8(jq, js)),
                               rtol=OPT_RTOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_compressed_psum_over_shard_mesh(shards):
    """Every shard gets the same sum, on a grid shared by the shards (the
    scale is the largest shard's): within S half-steps of the fp32 psum,
    and equal to the reference's arithmetic done by hand in numpy."""
    mesh = make_shard_mesh(shards, device="cpu")
    rng = np.random.default_rng(shards)
    xs = [rng.normal(size=(33,)).astype(np.float32) * (i + 1)
          for i in range(shards)]
    parts = [torch.from_numpy(x).to(d) for x, d in
             zip(xs, mesh.shard_devices("shard"))]
    out = compression.compressed_psum(parts)
    assert len(out) == shards
    exact = np.sum(xs, axis=0)
    scale = np.float32(max(np.abs(x).max() for x in xs) / np.float32(127.0)
                       + np.float32(1e-12))
    by_hand = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32)
                  for x in xs).astype(np.float32) * scale
    for o in out:
        np.testing.assert_array_equal(o.numpy(), out[0].numpy())
        assert np.abs(o.numpy() - exact).max() <= shards * scale / 2 + 1e-6
        np.testing.assert_allclose(o.numpy(), by_hand, rtol=OPT_RTOL,
                                   atol=OPT_ATOL)


def test_token_stream_matches_reference():
    from repro.data.synthetic import TokenStream as JTokenStream
    for structured in (False, True):
        a = TokenStream(50, 3, 9, seed=2, structured=structured)
        b = JTokenStream(50, 3, 9, seed=2, structured=structured)
        for _ in range(2):
            x, y = a.next(), b.next()
            for k in ("tokens", "targets"):
                np.testing.assert_array_equal(x[k], y[k])
        assert a.state_dict() == b.state_dict()


# ---------------------------------------------------------------------------
# checkpoints and the loop
# ---------------------------------------------------------------------------

class _ToyStream:
    def __init__(self, seed=0, step=0):
        self.seed, self.step = seed, step

    def next(self):
        rng = np.random.default_rng((self.seed, self.step))
        self.step += 1
        x = rng.normal(size=(8, 4)).astype(np.float32)
        return {"x": x, "y": (x.sum(1) > 0).astype(np.float32)}

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}


def test_async_checkpointer_snapshots_a_copy(tmp_path):
    """A CPU tensor written in place after ``save`` returns must not reach
    the file: the snapshot is a copy, not ``.cpu()``'s alias."""
    w = ckpt.AsyncCheckpointer()
    p = str(tmp_path / "async.npz")
    params = {"w": torch.arange(6, dtype=torch.float32), "n": [np.arange(3)]}
    w.save(p, params, step=1)
    params["w"].add_(100.0)
    params["n"][0][:] = -1
    w.wait()
    w.close()
    assert ckpt.latest_step(p) == 1
    back = ckpt.restore(p)
    np.testing.assert_array_equal(back["w"], np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(back["n"][0], [0, 1, 2])
    # and the reference reads it
    np.testing.assert_array_equal(jckpt.restore(p)["w"], back["w"])
    h = ckpt.PreemptionHandler()
    assert not h.preempted
    h._handler(None, None)
    assert h.preempted


def _gcn_parts(cfg, seed=0):
    loss = lambda p, b: gnn.loss_fn(cfg, p, b)
    init = lambda: gnn.init_params(cfg, torch.Generator().manual_seed(seed), 16)
    return loss, init


def test_loop_restart_is_bitwise(tmp_path):
    """10 steps straight == 5 steps, then a resume of 5 from the
    checkpoint: every parameter, optimizer state and loss bitwise."""
    cfg = jget("gcn-cora").smoke
    loss, init = _gcn_parts(cfg)
    o = opt.AdamWConfig(lr=0.01, warmup_steps=2, total_steps=10)
    p1, p2 = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    out1 = loop.run(loop.LoopConfig(total_steps=10, ckpt_path=p1, ckpt_every=3),
                    o, loss, init, ttrain._GraphStream(cfg), device="cpu")
    loop.run(loop.LoopConfig(total_steps=5, ckpt_path=p2, ckpt_every=100),
             o, loss, init, ttrain._GraphStream(cfg), device="cpu")
    assert ckpt.latest_step(p2) == 5
    out2 = loop.run(loop.LoopConfig(total_steps=10, ckpt_path=p2, ckpt_every=100),
                    o, loss, init, ttrain._GraphStream(cfg), device="cpu")
    assert [h["step"] for h in out2["history"]] == list(range(5, 10))
    assert [h["loss"] for h in out1["history"][5:]] == \
        [h["loss"] for h in out2["history"]]
    for a, b in zip(tree_leaves(out1), tree_leaves(out2)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert int(out2["opt_state"]["step"]) == 10
    back = loop.reshard_for_mesh(ckpt.restore(p2)["params"],
                                 make_shard_mesh(3, device="cpu"))
    assert len(back) == 3 and back[0] is back[2]
    for a, b in zip(tree_leaves(back[0]), tree_leaves(out2["params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch_id", ["gcn-cora", "gin-tu", "meshgraphnet",
                                     "dimenet"])
def test_launcher_setup_preempted_then_resumed_by_main(tmp_path, arch_id):
    """``launch.train.main --steps 6`` straight == 3 steps of
    ``train.setup``'s pieces cut by the preemption flag, then ``main``
    resumed from that checkpoint: every parameter, optimizer state and
    loss bitwise (the card's launcher check, at the smoke configs)."""
    def launcher(tag):
        return ttrain.main(["--arch", arch_id, "--steps", "6", "--device",
                            "cpu", "--ckpt", str(tmp_path / f"{tag}.npz")])

    straight = launcher("straight")
    s = ttrain.setup(arch_id, steps=6, device="cpu",
                     ckpt=str(tmp_path / "resumed.npz"))
    assert s.loop.total_steps == 6 and s.opt.warmup_steps == 1
    pre = ckpt.PreemptionHandler()
    cut = loop.run(s.loop, s.opt, s.loss, s.init, s.stream, device="cpu",
                   preemption=pre, hooks=[
                       lambda step, stats: setattr(pre, "preempted", step == 2)])
    assert [h["step"] for h in cut["history"]] == [0, 1, 2]
    resumed = launcher("resumed")
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in straight["history"]][3:]
    for a, b in zip(tree_leaves([straight["params"], straight["opt_state"]]),
                    tree_leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(a, b)


def _toy_runs(tmp_path, tag, first, second, init_np):
    """Steps 0-2 by ``first``'s loop, 3-5 by ``second``'s from its
    checkpoint; returns the second run's losses."""
    p = str(tmp_path / f"{tag}.npz")
    for pkg, total in ((first, 3), (second, 6)):
        o = (jopt if pkg == "jax" else opt).AdamWConfig(
            lr=0.05, warmup_steps=1, total_steps=6)
        if pkg == "jax":
            out = jloop.run(
                jloop.LoopConfig(total_steps=total, ckpt_path=p, ckpt_every=100),
                o, lambda pr, b: jnp.mean(jnp.square(b["x"] @ pr["w"] - b["y"])),
                lambda: {"w": jnp.asarray(init_np)}, _ToyStream(), async_ckpt=False)
        else:
            out = loop.run(
                loop.LoopConfig(total_steps=total, ckpt_path=p, ckpt_every=100),
                o, lambda pr, b: torch.mean(torch.square(b["x"] @ pr["w"] - b["y"])),
                lambda: {"w": torch.from_numpy(init_np.copy())}, _ToyStream(),
                device="cpu")
    return [h["loss"] for h in out["history"]]


def test_checkpoints_resume_across_packages(tmp_path):
    """A reference loop's checkpoint resumed by the port, and the port's by
    the reference: the resumed losses equal a straight run's."""
    init = np.asarray([0.3, -0.2, 0.1, 0.5], np.float32)
    straight = _toy_runs(tmp_path, "s", "jax", "jax", init)
    for tag, a, b in (("jt", "jax", "torch"), ("tj", "torch", "jax")):
        got = _toy_runs(tmp_path, tag, a, b, init)
        np.testing.assert_allclose(got, straight, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=tag)


def test_train_launcher_matches_reference(tmp_path, monkeypatch, capsys):
    """``repro_torch.launch.train --arch gcn-cora --device cpu`` on the
    reference's seeded parameters: the reference launcher's loss at every
    step, and the same printed line; a restart across packages resumes."""
    cfg = jget("gcn-cora").smoke
    jp = jgnn.init_params(cfg, jax.random.PRNGKey(0), 16)
    tp = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(ttrain.gnn, "init_params", lambda c, gen, d: tp)
    jout = jtrain.main(["--arch", "gcn-cora", "--steps", "6",
                        "--ckpt", str(tmp_path / "j.npz")])
    ref_line = capsys.readouterr().out.strip()
    out = ttrain.main(["--arch", "gcn-cora", "--steps", "6", "--device", "cpu",
                       "--ckpt", str(tmp_path / "t.npz")])
    line = capsys.readouterr().out.strip()
    jl = [h["loss"] for h in jout["history"]]
    tl = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert line.startswith(ref_line) and line.endswith("on cpu"), (line, ref_line)
    # the reference's 6-step checkpoint, continued by the port to 8 steps
    more = ttrain.main(["--arch", "gcn-cora", "--steps", "8", "--device", "cpu",
                        "--ckpt", str(tmp_path / "j.npz")])
    assert [h["step"] for h in more["history"]] == [6, 7]
    assert all(np.isfinite(h["loss"]) for h in more["history"])
    # the LM and recsys families train too (their parity is in
    # tests/test_torch_{lm,recsys}_training.py)
    for fam in ("qwen3-0.6b", "xdeepfm"):
        fout = ttrain.main(["--arch", fam, "--steps", "2", "--batch", "2",
                            "--seq", "32", "--device", "cpu",
                            "--ckpt", str(tmp_path / f"{fam}.npz")])
        assert [h["step"] for h in fout["history"]] == [0, 1]
        assert all(np.isfinite(h["loss"]) for h in fout["history"])


# ---------------------------------------------------------------------------
# the truss-filtered GCN loop (examples/evolving_graph_training.py)
# ---------------------------------------------------------------------------

def _truss_batch(g, k, d_feat, n_classes, pad_nodes, pad_edges, seed, smp):
    truss_edges = g.k_truss(k)
    if len(truss_edges) == 0:
        truss_edges = g.edge_list()
    return smp.make_gnn_batch(np.asarray(truss_edges, np.int64), g.spec.n_nodes,
                              d_feat, n_classes=n_classes, pad_nodes=pad_nodes,
                              pad_edges=pad_edges, seed=seed)


def test_truss_filtered_training_matches_reference():
    """Three rounds of the example's loop (400 nodes, k = 4, chunks of 8
    updates, 2 AdamW steps a round) through both packages: phi bitwise
    equal after every round, the same batches, losses within tolerance."""
    n, d_feat, k, rounds, steps = 400, 16, 4, 3, 2
    edges = powerlaw_graph(n, 5, seed=0)
    np.testing.assert_array_equal(edges, jpowerlaw_graph(n, 5, seed=0))
    cfg = jget("gcn-cora").smoke
    g = DynamicGraph(n, edges, tracked_ks=(k,), device="cpu")
    jg = JDynamicGraph(n, edges, tracked_ks=(k,))
    stream = GraphUpdateStream(g.edge_list().astype(np.int64), n, chunk=8, seed=1)
    jstream = JGraphUpdateStream(jg.edge_list().astype(np.int64), n, chunk=8, seed=1)
    jp = jgnn.init_params(cfg, jax.random.PRNGKey(0), d_feat)
    tp = gnn.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(lr=1e-2, total_steps=60, warmup_steps=5)
    jstep = jax.jit(jopt.make_train_step(lambda p, b: jgnn.loss_fn(cfg, p, b),
                                         jopt.AdamWConfig(**kw)))
    tstep = opt.make_train_step(lambda p, b: gnn.loss_fn(cfg, p, b),
                                opt.AdamWConfig(**kw))
    js, ts = jopt.adamw_init(jp), opt.adamw_init(tp)
    pad_edges = 4 * len(edges)
    for rnd in range(rounds):
        ups = stream.next()
        np.testing.assert_array_equal(ups, jstream.next())
        g.apply_batch([tuple(map(int, r)) for r in ups], strategy="auto")
        jg.apply_batch([tuple(map(int, r)) for r in ups], strategy="auto")
        assert g.phi_dict() == jg.phi_dict(), rnd
        b = _truss_batch(g, k, d_feat, cfg.n_classes, n, pad_edges, rnd, sampler)
        jb = _truss_batch(jg, k, d_feat, cfg.n_classes, n, pad_edges, rnd, jsampler)
        for key in jb:
            np.testing.assert_array_equal(b[key], jb[key])
        tb = gnn.batch_to_torch(b, "cpu")
        jb = {kk: jnp.asarray(v) for kk, v in jb.items()}
        for _ in range(steps):
            tp, ts, tstats = tstep(tp, ts, tb)
            jp, js, jstats = jstep(jp, js, jb)
            np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]),
                                       rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert len(g.k_truss(k)) == len(jg.k_truss(k)) > 0
    _close_trees(tp, jp, rtol=LOSS_RTOL, atol=LOSS_ATOL)
