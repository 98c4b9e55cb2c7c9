"""Checkpointing: device-agnostic save/restore of a tree of arrays.

PyTorch port of ``repro.training.checkpoint``'s synchronous half.  Arrays
are saved as host copies (``np.savez``) with the tree structure encoded in
flattened key paths (``state/__seq__``, ``state/0``, ...), the same layout
as the reference, so either package reads the other's files.  Leaves may
be torch tensors (on any device) or numpy arrays; numpy cannot hold
bfloat16 or fp8 through ``savez``, so those are stored as their raw bits
(uint16 / uint8) with a dtype tag in the key (``::bf16``,
``::float8_e4m3fn``, ``::float8_e5m2``).  Decoding a tag gives a torch
tensor of that dtype through an integer view: no ``ml_dtypes`` needed.

An atomic rename makes a partially written checkpoint invisible.  The
async writer snapshots synchronously and writes in a background thread;
its snapshot is always a host copy (``Tensor.to("cpu", copy=True)``, numpy
arrays copied), never a view: ``.cpu()`` of a CPU tensor is the tensor
itself, and a later in-place write to it must not reach the file.
SIGTERM sets the preemption handler's flag, on which the training loop
checkpoints and exits.
"""
from __future__ import annotations

import json
import os
import queue
import signal
import tempfile
import threading

import numpy as np
import torch

_TAG_OF_TORCH = {torch.bfloat16: ("::bf16", torch.int16, np.uint16),
                 torch.float8_e4m3fn: ("::float8_e4m3fn", torch.uint8,
                                       np.uint8),
                 torch.float8_e5m2: ("::float8_e5m2", torch.uint8, np.uint8)}
_TORCH_OF_TAG = {"bf16": (torch.bfloat16, np.int16),
                 "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
                 "float8_e5m2": (torch.float8_e5m2, np.uint8)}


def _encode_array(a) -> tuple[str, np.ndarray]:
    """``(tag, host array)`` for one leaf: a tensor is copied to the host;
    bfloat16 / fp8 (tensor, or a numpy array of an ``ml_dtypes`` type)
    become their raw bits with the dtype tag."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype in _TAG_OF_TORCH:
            tag, bits, np_bits = _TAG_OF_TORCH[a.dtype]
            return tag, a.view(bits).numpy().view(np_bits)
        return "", a.numpy()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return "::bf16", a.view(np.uint16)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        return f"::{a.dtype.name}", a.view(np.uint8)
    return "", a


def _decode_array(tag: str, a: np.ndarray):
    """An untagged leaf as stored (numpy); a tagged one as a CPU tensor of
    its dtype, bit for bit."""
    if not tag:
        return a
    dtype, np_bits = _TORCH_OF_TAG[tag]
    return torch.from_numpy(np.ascontiguousarray(a).view(np_bits)).view(dtype)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}__seq__"] = np.asarray(
            [len(tree), 1 if isinstance(tree, tuple) else 0])
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        tag, arr = _encode_array(tree)
        out[prefix.rstrip("/") + tag] = arr
    return out


def _unflatten(flat: dict):
    # rebuild nested structure from key paths
    def insert(d, parts, v):
        if len(parts) == 1:
            d[parts[0]] = v
        else:
            d = d.setdefault(parts[0], {})
            insert(d, parts[1:], v)

    root: dict = {}
    for k, v in flat.items():
        if "::" in k:
            k, tag = k.rsplit("::", 1)
            v = _decode_array(tag, v)
        insert(root, k.split("/"), v)

    def fix(node):
        if isinstance(node, dict):
            if "__seq__" in node:
                n, is_tuple = int(node["__seq__"][0]), int(node["__seq__"][1])
                seq = [fix(node[str(i)]) for i in range(n)]
                return tuple(seq) if is_tuple else seq
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def to_device(tree, device):
    """A tree of numpy arrays and tensors as tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, np.ndarray):
        tree = torch.from_numpy(np.array(tree))
    return tree.to(device)


def save(path: str, tree, step: int | None = None) -> None:
    """Write ``tree`` to ``path`` (an ``.npz``) through a temporary file
    and an atomic rename; ``step`` goes to ``<path>.meta.json``."""
    flat = _flatten(tree)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    if step is not None:
        meta = path + ".meta.json"
        with open(meta, "w") as f:
            json.dump({"step": step}, f)


def restore(path: str, device=None):
    """The tree saved at ``path``.  With ``device=None`` untagged leaves
    come back as numpy arrays and tagged ones (bf16, fp8) as CPU tensors;
    with a device every leaf comes back as a tensor on it."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    if device is not None:
        tree = to_device(tree, torch.device(device))
    return tree


def latest_step(path: str) -> int | None:
    """The ``step`` saved beside ``path``, or None when there is none."""
    meta = path + ".meta.json"
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["step"]


def _host_copy(tree):
    """A copy of ``tree`` on the host: tensors copied to the CPU (a CPU
    tensor too), numpy arrays copied, other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


class AsyncCheckpointer:
    """Snapshot synchronously (a host copy), write in background; a bounded
    queue applies back-pressure instead of dropping checkpoints."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._errors: list = []
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            path, tree, step = item
            try:
                save(path, tree, step)
            except Exception as e:  # surfaced on next save()/wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def save(self, path: str, tree, step: int | None = None):
        if self._errors:
            raise self._errors.pop()
        self._q.put((path, _host_copy(tree), step))

    def wait(self):
        self._q.join()
        if self._errors:
            raise self._errors.pop()

    def close(self):
        self._q.put(None)
        self._thread.join()


class PreemptionHandler:
    """SIGTERM -> set flag; the training loop checkpoints and exits cleanly
    (what a maintenance event looks like to the worker)."""

    def __init__(self):
        self.preempted = False
        try:
            signal.signal(signal.SIGTERM, self._handler)
        except ValueError:
            pass  # non-main thread (tests)

    def _handler(self, signum, frame):
        self.preempted = True
