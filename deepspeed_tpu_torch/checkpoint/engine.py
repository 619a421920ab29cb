"""Checkpoint save and load with a fragment store.

Counterpart of ``deepspeed_tpu/checkpoint/engine.py``, on one process.
The on-disk format is the JAX package's, byte for byte:

    <dir>/<tag>/manifest.json       # leaves (shape, dtype, fragments), step...
    <dir>/<tag>/manifest_p0.json    # the process's partial manifest
    <dir>/<tag>/p0_<n>.npy          # one fragment = one slice of a leaf
    <dir>/latest                    # tag pointer

Each leaf is keyed by the string ``jax.tree_util.keystr`` gives for its
path (``.master['blocks']['attn']['wq']``, ``.opt_state.m[...]``,
``.loss_scale.scale``), in jax's flattening order (dict keys sorted,
NamedTuple fields in order, ``None`` no leaf).  Python numbers (the
port's step and loss-scaler state) are written as 0-d ``int32`` /
``float32`` arrays, as the JAX engine holds them.

bf16 leaves are written as the JAX package writes them: 2-byte words
under the numpy descr ``'<V2'``, with ``"bfloat16"`` in the manifest.
They are read back by the manifest's dtype, the words viewed as
``torch.bfloat16`` (no ``ml_dtypes`` needed; the JAX reader's cast of
these words into a bfloat16 array raises instead).

One process writes everything and the barriers of the multi-host
reference have nothing to wait for.  A leaf is read from any set of
fragments that covers it, so a checkpoint the JAX package saved on a
multi-device mesh (one fragment per shard) loads here whole: the
reference's elastic resume.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist

MANIFEST = "manifest.json"
LATEST = "latest"

# numpy cannot hold bfloat16 without ml_dtypes: its leaves travel as their
# 16-bit words
_BF16 = "bfloat16"
_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: _BF16, torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


# --------------------------------------------------------------------------
# path <-> string keys (jax.tree_util.keystr)
# --------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key suffix, child) pairs of an inner node in jax's order, or None
    for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(keystr, leaf)] in jax's flattening order; ``None`` is no leaf."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, v in kids for x in _leaf_paths(v, prefix + k)]


def _map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(keystr, leaf)``, in the
    tree's own structure (dict order kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + f"[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map_with_path(fn, getattr(tree, f),
                                           prefix + f".{f}")
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, prefix + f"[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the trees this
    package saves (dicts, NamedTuples, lists, tuples, None)."""
    def node(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {node(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], ["
                    + ", ".join(node(v) for v in x) + "])")
        if isinstance(x, tuple):
            return "(" + ", ".join(node(v) for v in x) + \
                ("," if len(x) == 1 else "") + ")"
        if isinstance(x, list):
            return "[" + ", ".join(node(v) for v in x) + "]"
        return "*"
    return f"PyTreeDef({node(tree)})"


def _index_to_slices(index, shape) -> List[List[int]]:
    """Normalize a shard index (tuple of slices) to [[start, stop], ...]."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


# --------------------------------------------------------------------------
# save
# --------------------------------------------------------------------------

class HostShards:
    """Host snapshot of one leaf, the payload of an async save: its
    shape, manifest dtype name and the fragments the synchronous writer
    would emit (one process, one device: the whole leaf), as numpy words
    (a bf16 leaf as its uint16 words).  The on-disk layout is the same
    whichever path wrote it."""

    def __init__(self, arr):
        data, self.dtype = _host_words(arr)
        self.shape = tuple(data.shape)
        self.shards = [(tuple(slice(0, d) for d in self.shape), data)]


def _host_words(leaf) -> Tuple[np.ndarray, str]:
    """(host numpy array, manifest dtype name) of a leaf: a tensor (a
    16-bit float one as its words), a numpy array, or a Python number (a
    0-d int32 / float32 array, as the JAX engine's state holds it)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = _TORCH_NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"cannot checkpoint a {t.dtype} leaf")
        # a copy also on the CPU: the engine updates its state in place
        if name == _BF16:
            return (t.contiguous().view(torch.int16).to("cpu", copy=True)
                    .numpy().view(np.uint16), name)
        return t.to("cpu", copy=True).numpy(), name
    if isinstance(leaf, (bool, np.bool_)):
        return np.asarray(leaf, np.bool_), "bool"
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32), "int32"
    if isinstance(leaf, (float, np.floating)) and np.ndim(leaf) == 0:
        return np.asarray(leaf, np.float32), "float32"
    a = np.asarray(leaf)
    return a, a.dtype.name


def _write_fragment(path: str, data: np.ndarray, dtype: str) -> None:
    """``np.save`` of one fragment; a bf16 leaf's words get the header
    ``np.save`` writes for an ``ml_dtypes`` array: descr ``'<V2'``."""
    if dtype != _BF16:
        np.save(path, np.asarray(data, order="C"))
        return
    data = np.asarray(data, order="C")
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": data.shape})
        f.write(data.tobytes())


def save_tree(tree: Any, ckpt_dir: str,
              extra_meta: Optional[Dict] = None) -> None:
    """Write a tree of tensors, numpy arrays and Python numbers, or of
    :class:`HostShards` snapshots (the async path), as fragments plus the
    manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    # re-saving into an existing tag: clear stale fragments/manifests
    # first (left behind, they would leak into the merged manifest)
    for fn in os.listdir(ckpt_dir):
        if fn.endswith(".npy") or fn.startswith("manifest"):
            os.remove(os.path.join(ckpt_dir, fn))
    entries: Dict[str, Dict] = {}
    frag_n = 0
    for key, leaf in _leaf_paths(tree):
        snap = leaf if isinstance(leaf, HostShards) else HostShards(leaf)
        frags = []
        for index, data in snap.shards:
            fname = f"p0_{frag_n}.npy"
            frag_n += 1
            _write_fragment(os.path.join(ckpt_dir, fname), data, snap.dtype)
            frags.append({"file": fname,
                          "index": _index_to_slices(index, snap.shape)})
        entries[key] = {"shape": list(snap.shape), "dtype": snap.dtype,
                        "fragments": frags}
    # the process's partial manifest, then the merged one (one process:
    # the same entries)
    with open(os.path.join(ckpt_dir, "manifest_p0.json"), "w") as f:
        json.dump(entries, f)
    meta = {"leaves": entries, "treedef": _treedef_str(tree),
            "time": time.time(), **(extra_meta or {})}
    with open(os.path.join(ckpt_dir, MANIFEST), "w") as f:
        json.dump(meta, f, indent=1)


# --------------------------------------------------------------------------
# load
# --------------------------------------------------------------------------

class _FragmentReader:
    """Assemble arbitrary global slices of one leaf from its saved
    fragments (memory-mapped), in the manifest's dtype (bf16 as its
    16-bit words)."""

    def __init__(self, ckpt_dir: str, entry: Dict):
        self.dir = ckpt_dir
        self.shape = tuple(entry["shape"])
        self.dtype_name = entry["dtype"]
        self.dtype = np.dtype(np.uint16 if self.dtype_name == _BF16
                              else self.dtype_name)
        self.fragments = entry["fragments"]
        self._cache: Dict[str, np.ndarray] = {}

    def _frag(self, fname: str) -> np.ndarray:
        if fname not in self._cache:
            a = np.load(os.path.join(self.dir, fname), mmap_mode="r")
            if a.dtype != self.dtype:
                if a.dtype.itemsize != self.dtype.itemsize:
                    raise ValueError(
                        f"fragment {fname}: {a.dtype} words for a "
                        f"{self.dtype_name} leaf")
                a = a.view(self.dtype)     # '<V2' words of a bf16 leaf
            self._cache[fname] = a
        return self._cache[fname]

    def read(self, index: Tuple[slice, ...]) -> np.ndarray:
        """Read the global slice ``index`` from the overlapping
        fragments."""
        tgt = _index_to_slices(index, self.shape)
        if not tgt:  # scalar
            return np.array(self._frag(self.fragments[0]["file"]))
        out_shape = tuple(b - a for a, b in tgt)
        out = np.empty(out_shape, self.dtype)
        filled = 0
        for frag in self.fragments:
            src = frag["index"]
            inter = [(max(a1, a2), min(b1, b2))
                     for (a1, b1), (a2, b2) in zip(tgt, src)]
            if any(a >= b for a, b in inter):
                continue
            dst_sel = tuple(slice(a - t[0], b - t[0])
                            for (a, b), t in zip(inter, tgt))
            src_sel = tuple(slice(a - s[0], b - s[0])
                            for (a, b), s in zip(inter, src))
            out[dst_sel] = self._frag(frag["file"])[src_sel]
            filled += int(np.prod([b - a for a, b in inter]))
        if filled != int(np.prod(out_shape)):
            raise ValueError(
                f"Checkpoint fragments only cover {filled}/"
                f"{np.prod(out_shape)} elements of requested slice "
                "(corrupt or partial checkpoint)")
        return out

    def tensor(self) -> torch.Tensor:
        """The whole leaf as a host tensor of its manifest dtype."""
        a = self.read(tuple(slice(0, d) for d in self.shape))
        t = torch.from_numpy(np.asarray(a, order="C"))
        if self.dtype_name == _BF16:
            t = t.view(torch.int16).view(torch.bfloat16)
        return t


def _leaf_from(reader: _FragmentReader, leaf, device):
    """The checkpoint's value for ``leaf``, in the leaf's own kind: a
    tensor cast to the leaf's dtype on ``device`` (None: the leaf's
    device), a numpy array of its dtype, or a Python number."""
    t = reader.tensor()
    if isinstance(leaf, torch.Tensor):
        dev = leaf.device if device is None else torch.device(device)
        return t.to(device=dev, dtype=leaf.dtype)
    if isinstance(leaf, (bool, np.bool_)):
        return bool(t.item())
    if isinstance(leaf, (int, np.integer)):
        return int(t.item())
    if isinstance(leaf, (float, np.floating)) and np.ndim(leaf) == 0:
        return float(t.item())
    a = np.asarray(leaf)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().astype(a.dtype)


def _check_entry(key: str, entry: Dict, leaf) -> None:
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
    if tuple(entry["shape"]) != shape:
        raise ValueError(
            f"Shape mismatch for {key}: ckpt {entry['shape']} vs "
            f"{list(shape)}")


def _read_manifest(ckpt_dir: str) -> Dict:
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        return json.load(f)


def load_tree(template: Any, shardings: Any, ckpt_dir: str,
              strict: bool = True) -> Tuple[Any, Dict]:
    """Load a tree saved by :func:`save_tree` (here or by the JAX
    package, on any mesh) into ``template``'s structure.

    ``template`` supplies structure, shapes and dtypes: each tensor leaf
    comes back cast to its dtype, numbers as numbers.  ``shardings`` is
    the device the tensors land on (one device: the reference's sharding
    tree reduces to it); None keeps each leaf's own device.  Returns
    (tree, manifest meta)."""
    meta = _read_manifest(ckpt_dir)
    entries = meta["leaves"]
    device = shardings

    def one(key, leaf):
        if key not in entries:
            if strict:
                raise KeyError(f"Checkpoint missing leaf {key}")
            return leaf
        _check_entry(key, entries[key], leaf)
        return _leaf_from(_FragmentReader(ckpt_dir, entries[key]), leaf,
                          device)

    return _map_with_path(one, template), meta


def load_tree_host(template: Any, ckpt_dir: str,
                   strict: bool = True) -> Tuple[Any, Dict]:
    """Like :func:`load_tree` but every tensor leaf lands in host memory
    (the ZeRO-Infinity path of the reference reads fp32 state this way)."""
    return load_tree(template, torch.device("cpu"), ckpt_dir, strict=strict)


# --------------------------------------------------------------------------
# engine-level save/load
# --------------------------------------------------------------------------

def _extra(engine, client_state: Optional[Dict]) -> Dict:
    return {
        "global_steps": engine.global_steps,
        "global_samples": engine.global_samples,
        "zero_stage": engine.zero_stage,
        "precision": engine.precision,
        # the JAX engine's axis sizes, in its order (one device)
        "mesh": {a: 1 for a in ("pipe", "data", "fsdp", "expert", "seq",
                                "tensor")},
        "client_state": client_state or {},
    }


def _write_latest(save_dir: str, tag: str) -> None:
    with open(os.path.join(save_dir, LATEST), "w") as f:
        f.write(tag)


def save_checkpoint(engine, save_dir: str, tag: Optional[str] = None,
                    client_state: Optional[Dict] = None) -> str:
    tag = tag or f"global_step{engine.global_steps}"
    ckpt_dir = os.path.join(save_dir, tag)
    save_tree(engine.state, ckpt_dir, extra_meta=_extra(engine,
                                                        client_state))
    _write_latest(save_dir, tag)
    log_dist(f"saved checkpoint {ckpt_dir}")
    return ckpt_dir


class AsyncCheckpointSaver:
    """Background checkpoint writes.  The state is copied to host memory
    synchronously (the next step updates it in place), then the fragments
    and the ``latest`` pointer are written on a worker thread while
    training continues.  At most one save is in flight; a new submit
    drains the previous one first."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # the final save of a run lands even if wait() is never called
        atexit.register(self._drain_silent)

    def _drain_silent(self):
        try:
            self.wait()
        except Exception as e:       # best-effort at exit: report it
            # logging may already be torn down at interpreter exit
            print(f"async checkpoint failed at exit: {e!r}",
                  file=sys.stderr)

    def submit(self, host_state, ckpt_dir: str, extra: Dict,
               save_dir: str, tag: str) -> None:
        self.wait()

        def work():
            try:
                save_tree(host_state, ckpt_dir, extra_meta=extra)
                # written only after every fragment landed: a crash
                # mid-save never points `latest` at a torn tag
                _write_latest(save_dir, tag)
                log_dist(f"async-saved checkpoint {ckpt_dir}")
            # re-raised to the caller by the next wait()/submit(); wait()
            # joins this thread before it reads _error
            except Exception as e:  # tpulint: disable=silent-except
                self._error = e  # tpulint: disable=shared-state-race

        self._thread = threading.Thread(target=work, daemon=False,
                                        name="async-ckpt")
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save; re-raises its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def save_checkpoint_async(engine, saver: AsyncCheckpointSaver,
                          save_dir: str, tag: Optional[str] = None,
                          client_state: Optional[Dict] = None) -> str:
    """Non-blocking :func:`save_checkpoint`: the host snapshot is taken
    now, the files are written by ``saver``'s worker."""
    tag = tag or f"global_step{engine.global_steps}"
    ckpt_dir = os.path.join(save_dir, tag)
    extra = _extra(engine, client_state)
    host_state = _map_with_path(lambda _, x: HostShards(x), engine.state)
    saver.submit(host_state, ckpt_dir, extra, save_dir, tag)
    return ckpt_dir


def read_latest(load_dir: str) -> str:
    latest = os.path.join(load_dir, LATEST)
    if not os.path.exists(latest):
        raise FileNotFoundError(f"No {LATEST} file in {load_dir}")
    with open(latest) as f:
        return f.read().strip()


def load_checkpoint(engine, load_dir: str, tag: Optional[str] = None):
    """Load ``load_dir/tag`` (``latest`` when None) into the engine's
    state, each leaf on the engine's device in its dtype, and restore
    ``global_steps`` / ``global_samples``.  Returns (ckpt_dir,
    client_state)."""
    ckpt_dir = os.path.join(load_dir, tag if tag is not None
                            else read_latest(load_dir))
    state, meta = load_tree(engine.state, engine.device, ckpt_dir)
    engine.state = state
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.global_samples = int(meta.get("global_samples", 0))
    log_dist(f"loaded checkpoint {ckpt_dir} (step {engine.global_steps})")
    return ckpt_dir, meta.get("client_state", {})


# --------------------------------------------------------------------------
# consolidation (reference: utils/zero_to_fp32.py)
# --------------------------------------------------------------------------

def consolidate(ckpt_dir: str, prefix: str = ".master"
                ) -> Dict[str, np.ndarray]:
    """Reassemble full arrays from a fragment checkpoint, for every leaf
    whose key holds ``prefix`` — the ``zero_to_fp32.py`` analog.  A bf16
    leaf comes back widened to float32 (exact)."""
    meta = _read_manifest(ckpt_dir)
    out = {}
    for key, entry in meta["leaves"].items():
        if prefix and prefix not in key:
            continue
        t = _FragmentReader(ckpt_dir, entry).tensor()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[key] = t.numpy()
    return out
