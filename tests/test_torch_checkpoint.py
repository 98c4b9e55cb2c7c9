"""``repro_torch.training.checkpoint`` against ``repro.training.checkpoint``:
a file written by either package loads in the other to equal arrays and
dtypes (int32, bool, float32, a bf16 leaf, nested tuples and lists), and
``latest_step`` agrees."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as J
from repro_torch.training import checkpoint as T


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng):
    """Host arrays of every kind the service's snapshots hold, plus a
    bf16 leaf, in nested dicts, tuples and lists."""
    bf = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "spec": [13, 16, 160],
        "state": (rng.integers(0, 99, (4, 2)).astype(np.int32),
                  rng.random(4) < 0.5,
                  rng.standard_normal(6).astype(np.float32)),
        "nested": {"a": [np.arange(3, dtype=np.int32),
                         (np.zeros((0, 2), np.int32), np.int32(7))],
                   "bf16": bf},
        "gen": 5,
    }


def _as_jax(tree):
    out = dict(tree)
    out["nested"] = dict(tree["nested"],
                         bf16=jnp.asarray(tree["nested"]["bf16"], jnp.bfloat16))
    return out


def _as_torch(tree):
    out = dict(tree)
    out["state"] = tuple(torch.from_numpy(np.array(x)) for x in tree["state"])
    out["nested"] = dict(tree["nested"], bf16=torch.from_numpy(
        tree["nested"]["bf16"]).to(torch.bfloat16))
    return out


def _bits(x):
    """(dtype name, shape, raw bytes) of a leaf from either package."""
    if isinstance(x, torch.Tensor):
        name = {torch.bfloat16: "bfloat16"}.get(x.dtype)
        if name is not None:
            return name, tuple(x.shape), x.view(torch.int16).numpy().tobytes()
        x = x.numpy()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def _assert_same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, (np.ndarray, torch.Tensor))
                                  and isinstance(b, (np.ndarray, torch.Tensor)))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    else:
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_either_package_reads_the_others_file(writer, tmp_path):
    tree = _tree(np.random.default_rng(3))
    path = str(tmp_path / "ck.npz")
    if writer == "repro":
        J.save(path, _as_jax(tree), step=11)
    else:
        T.save(path, _as_torch(tree), step=11)
    got_j, got_t = J.restore(path), T.restore(path)
    _assert_same_tree(got_j, got_t)
    assert got_t["nested"]["bf16"].dtype == torch.bfloat16
    assert str(got_j["nested"]["bf16"].dtype) == "bfloat16"
    assert got_t["state"][0].dtype == np.int32
    assert got_t["state"][1].dtype == np.bool_
    assert got_t["state"][2].dtype == np.float32
    assert isinstance(got_t["state"], tuple)
    assert isinstance(got_t["nested"]["a"], list)
    assert isinstance(got_t["nested"]["a"][1], tuple)
    assert int(got_t["gen"]) == 5 and [int(x) for x in got_t["spec"]] == [
        13, 16, 160]
    bf_ref = torch.from_numpy(tree["nested"]["bf16"]).to(torch.bfloat16)
    assert torch.equal(got_t["nested"]["bf16"], bf_ref)
    with np.load(path) as z:
        assert "state/__seq__" in z.files and "state/0" in z.files
        assert "nested/bf16::bf16" in z.files
    assert J.latest_step(path) == T.latest_step(path) == 11


def test_fp8_leaves_round_trip_and_device_restore(tmp_path):
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    tree = {"e4m3": vals.to(torch.float8_e4m3fn),
            "e5m2": vals.to(torch.float8_e5m2), "i": np.arange(4)}
    path = str(tmp_path / "f8.npz")
    T.save(path, tree)
    got = T.restore(path)
    for k in ("e4m3", "e5m2"):
        assert got[k].dtype == tree[k].dtype
        assert torch.equal(got[k].view(torch.uint8), tree[k].view(torch.uint8))
    ref = J.restore(path)
    assert str(ref["e4m3"].dtype) == "float8_e4m3fn"
    assert np.array_equal(np.asarray(ref["e5m2"]).view(np.uint8),
                          tree["e5m2"].view(torch.uint8).numpy())
    on = T.restore(path, device="cpu")
    assert isinstance(on["i"], torch.Tensor) and on["i"].tolist() == [0, 1, 2, 3]
    assert T.latest_step(path) is None
    # the write goes through one temporary file, renamed away
    assert sorted(os.listdir(tmp_path)) == ["f8.npz"]

