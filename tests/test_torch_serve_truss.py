"""The port's truss launcher (``repro_torch.launch.serve_truss``) in-process
with ``--device cpu``, against the reference's ``main(argv)`` on the same
seed and flags.

Each mode runs in both packages with telemetry off (so no random trace id
enters either WAL as a ``# trace`` annotation) and must end at the same
generation with the same phi and a byte-identical ``wal.log`` and
``commit.json``: a single primary, then ``--restore`` (continuing from the
next generation), and ``--router --replicas 2``.  With telemetry on, a
router run's ``--trace-jsonl`` file merges (``python -m
repro_torch.obs.merge``) into a trace whose ids join the replicas' applies
to the router's writes.  ``--replica-of``, ``--scrub`` and
``--wave-profile`` run too.
"""
import contextlib
import json
import os

import pytest
import torch

import repro.obs as j_obs
import repro_torch.obs as t_obs
from repro.launch import serve_truss as j_cli
from repro_torch.cluster import QueryRouter, Replica
from repro_torch.launch import serve_truss as t_cli
from repro_torch.obs import merge

ARGS = ["--nodes", "60", "--degree", "4", "--chunk", "6",
        "--flush-every", "8", "--seed", "3"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the driver runs the
    suite in several worker processes, and torch's thread pool in each of
    them oversubscribes the host's cores on these tiny shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _quiet():
    """Telemetry off in both packages: no trace context, no annotation."""
    with j_obs.disabled(), t_obs.disabled():
        yield


def _port(argv):
    return t_cli.main(argv + ["--device", "cpu"])


def _primary(obj):
    if isinstance(obj, QueryRouter):
        return obj.primary
    return obj.svc if isinstance(obj, Replica) else obj


def _read(root, name):
    with open(os.path.join(root, name), "rb") as f:
        return f.read()


def _same_run(t_obj, j_obj, t_root, j_root):
    t_svc, j_svc = _primary(t_obj), j_cli._primary_of(j_obj)
    assert t_obj.exit_code == j_obj.exit_code == 0
    assert t_svc.gen == j_svc.gen
    assert t_svc.graph.phi_dict() == j_svc.graph.phi_dict()
    for name in ("wal.log", "commit.json"):
        assert _read(t_root, name) == _read(j_root, name), name
    return t_svc.gen


def test_run_then_restore_match_reference(tmp_path, capsys):
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    with _quiet():
        gen = _same_run(_port(ARGS + ["--store", t_root, "--ticks", "3"]),
                        j_cli.main(ARGS + ["--store", j_root, "--ticks", "3"]),
                        t_root, j_root)
        assert gen >= 3
        out = capsys.readouterr().out
        assert "snapshot ->" in out and "final:" in out
        restored = _port(ARGS + ["--store", t_root, "--restore",
                                 "--ticks", "2"])
        j_restored = j_cli.main(ARGS + ["--store", j_root, "--restore",
                                        "--ticks", "2"])
        # the restored run continues from the next generation
        assert f"'gen': {gen}," in capsys.readouterr().out.split(
            "restored: ")[1]
        assert _same_run(restored, j_restored, t_root, j_root) > gen


def test_router_replicas_match_reference(tmp_path):
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    flags = ["--router", "--replicas", "2", "--ticks", "3", "--chunk", "24"]
    with _quiet():
        t_obj = _port(ARGS + flags + ["--store", t_root])
        j_obj = j_cli.main(ARGS + flags + ["--store", j_root])
    _same_run(t_obj, j_obj, t_root, j_root)
    assert isinstance(t_obj, QueryRouter) and len(t_obj.replicas) == 2
    # the replicas polled once a tick: each is bitwise equal to the primary
    # at its own generation, at most the primary's
    st = t_obj.stats()
    assert sum(st["served"].values()) > 0
    for rep in t_obj.replicas:
        rep.poll()
        assert rep.gen == t_obj.primary.gen
        for x, y in zip(rep.svc.graph.state, t_obj.primary.graph.state):
            assert torch.equal(x, y)


def test_trace_jsonl_merges_replica_applies_into_write_traces(tmp_path,
                                                              capsys):
    root, jsonl = str(tmp_path / "s"), str(tmp_path / "router.jsonl")
    obj = _port(ARGS + ["--store", root, "--router", "--replicas", "1",
                        "--ticks", "3", "--chunk", "24", "--trace-jsonl",
                        jsonl, "--trace-out", str(tmp_path / "chrome.json")])
    assert obj.exit_code == 0
    out = capsys.readouterr().out
    assert f"trace jsonl -> {jsonl}" in out
    assert json.load(open(tmp_path / "chrome.json"))["traceEvents"]
    merged = str(tmp_path / "merged.json")
    assert merge.main([merged, jsonl]) == 0
    doc = json.load(open(merged))
    names: dict = {}
    for ev in doc["traceEvents"]:
        tid = (ev.get("args") or {}).get("trace_id")
        if ev.get("ph") == "X" and tid is not None:
            names.setdefault(tid, set()).add(ev["name"])
    joined = [n for n in names.values()
              if "gen.replay" in n and any(x.startswith("router.write")
                                           for x in n)]
    assert joined, "no replica apply joined a router write's trace"


def test_replica_mode_scrub_and_wave_profile(tmp_path, capsys):
    root = str(tmp_path / "s")
    with _quiet():
        svc = _port(ARGS + ["--store", root, "--ticks", "2"])
        rep = _port(ARGS + ["--replica-of", root, "--ticks", "2",
                            "--poll-interval", "0"])
        assert isinstance(rep, Replica) and rep.gen == svc.gen
        assert rep.exit_code == 0
        again = _port(ARGS + ["--store", root, "--restore", "--ticks", "1",
                              "--scrub", "--wave-profile"])
    out = capsys.readouterr().out
    assert "scrub: ok=True violations=none" in out
    assert again.exit_code == 0 and again.gen > svc.gen
