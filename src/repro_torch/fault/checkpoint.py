"""Crash-safe checkpointing of solves and path sweeps (port of
`repro.fault.checkpoint`, on-disk format unchanged).

Layout:  <dir>/step_<N>/       (N zero-padded to 8 digits)
            manifest.json     -- step, tree description, leaf count, extra
            arrays.npz        -- one entry per leaf, named f"{i:05d}§{name}"
                                 with the leaves in sorted key order
            COMMITTED         -- written last; a step without it is
                                 incomplete and ignored on restore
Leaves are full host arrays (a sharded backend gathers them over its
mesh, and its rank 0 writes them). Every file is fsynced, the step directory
lands by an atomic rename, stale `.tmp_ckpt_` directories of crashed
writers are removed, and the `keep` newest steps are kept. The .npz is
np.savez's (stored members, .npy format 1.0), written a member at a time
with a device tensor's bytes through one pinned staging buffer
(`_write_npz`), and `restore` reads each member with one np.fromfile at
its offset, its CRC-32 checked (`_read_member`), where np.load reads
through small buffered copies (`benchmarks/port/ckpt_io.py` times both
ways).

Trees are nested dicts (sorted keys), tuples, lists and NamedTuples, with
None an empty subtree, flattened in `jax.tree_util`'s leaf order under
the reference's `_flatten_with_names` names (a dict key, a sequence
index, ".field" for a NamedTuple field, joined by "§"); a flat dict is
its sorted keys. Leaves are tensors (bfloat16 kept as its 16 bits, the
"|V2" entries the reference's bfloat16 leaves become in an .npz), numpy
arrays or numbers. So a checkpoint written by either package restores in
the other:

* `CheckpointManager` -- the generic store; `restore(like)` casts each
  leaf to `like`'s dtype (and device, for tensors), as the reference's
  does.
* `SolveCheckpointer` -- the solver / sweep layer the engine and
  `path.driver.run_path` use. A snapshot holds exactly the reference's
  leaves: `w`, `z`, `active` (unpadded host arrays) and `key`, a (2,)
  uint32 the reference's `restore_state` accepts (a hash of the generator
  state; the packages draw partitions differently, so no key crosses
  meaningfully). The port's own `torch.Generator` state rides in the
  manifest's `extra` as base64 text (`GEN_STATE`), which the reference
  ignores; a checkpoint without it restores with the generator seeded
  from cfg.seed.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import shutil
import struct
import tempfile
import zipfile
import zlib
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.fault.atomic import fsync_dir

_SEP = "§"
GEN_STATE = "torch_generator_state"   # manifest extra key (base64 uint8)


def _fsync_file(path: str) -> None:
    with open(path, "rb") as fh:
        os.fsync(fh.fileno())


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(name part, child)] of an inner node, in `jax.tree_util`'s order;
    None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def flatten_with_names(tree) -> list:
    """[(name, leaf)] in the reference's leaf order and names (its
    `_flatten_with_names`); None holds no leaf."""
    out = []
    _walk((), tree, out)
    return out


# The recursions are module functions: a nested function that calls
# itself sits in a reference cycle with its closure, which would keep
# the leaves it collected (a save's stacked copy of the state, on the
# card) alive after the call until the next garbage collection.
def _walk(path, node, out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((_SEP.join(path) or "leaf", node))
        return
    for part, child in kids:
        _walk(path + (part,), child, out)


def unflatten_like(like, leaves: list):
    """A tree of `like`'s structure holding `leaves` in leaf order."""
    return _build(like, iter(leaves))


def _build(node, it):
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return next(it)
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    built = [_build(c, it) for _, c in kids]
    if _is_namedtuple(node):
        return type(node)(*built)
    return type(node)(built)


def _treedef(tree) -> str:
    """The tree description the reference's manifest carries
    (`str(treedef)`; informational: restores never read it)."""
    def desc(node):
        if node is None:
            return "None"
        kids = _children(node)
        if kids is None:
            return "*"
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {desc(c)}"
                                   for k, c in kids) + "}"
        inner = ", ".join(desc(c) for _, c in kids)
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], "
                    f"[{inner}])")
        if isinstance(node, list):
            return f"[{inner}]"
        return f"({inner}{',' if len(kids) == 1 else ''})"
    return f"PyTreeDef({desc(tree)})"


def _to_host(leaf) -> np.ndarray:
    """A leaf as the host array the .npz holds: bfloat16 tensors as their
    16 bits ("|V2", as numpy saves the reference's bfloat16 leaves)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _writable(arr: np.ndarray) -> np.ndarray:
    """`arr` itself when torch may wrap it (C-contiguous and writable, as
    an array np.load reads is), else a copy."""
    return np.require(arr, requirements=("C", "W"))


def _from_host(arr: np.ndarray, like):
    """A loaded array cast to `like`'s dtype (and device for a tensor);
    "|V2" entries are bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(_writable(arr.view(np.int16))).view(
            torch.bfloat16)
    else:
        t = None
    if isinstance(like, torch.Tensor):
        if t is None:
            t = torch.from_numpy(_writable(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if t is not None:
        arr = t.to(torch.float32).numpy()
    dtype = getattr(like, "dtype", None)
    return np.asarray(arr, dtype=dtype) if dtype is not None else arr


_STAGING = 64 << 20      # bytes a device-to-host copy of a write


def _np_dtype(t: torch.Tensor) -> np.dtype:
    """The host dtype of a tensor's .npz entry ("|V2" for bfloat16)."""
    if t.dtype == torch.bfloat16:
        return np.dtype("V2")
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _write_npz(path: str, named: list) -> None:
    """The file `np.savez(path, **{key: _to_host(leaf)})` writes, for
    `named` [(key, leaf)]: a stored zip of one member `<key>.npy` a leaf,
    each an .npy of format 1.0 (C order). A device tensor's bytes go to
    its member through one pinned staging buffer, _STAGING bytes a copy,
    and a host array's in one write: np.savez copies each array to the
    host whole (pageable, for a tensor), then through 16 MiB chunks."""
    fmt = np.lib.format
    staging = None
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in named:
            on_device = isinstance(leaf, torch.Tensor) and \
                leaf.device.type != "cpu"
            if on_device:
                t = leaf.detach().contiguous()
                header = {"descr": fmt.dtype_to_descr(_np_dtype(t)),
                          "fortran_order": False, "shape": tuple(t.shape)}
                data = t.reshape(-1).view(torch.uint8)
            else:
                arr = np.require(_to_host(leaf), requirements="C")
                header = fmt.header_data_from_array_1_0(arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as fh:
                fmt.write_array_header_1_0(fh, header)
                if not on_device:
                    fh.write(arr.reshape(-1).view(np.uint8).data)
                    continue
                if staging is None:
                    staging = torch.empty(_STAGING, dtype=torch.uint8,
                                          pin_memory=True)
                for off in range(0, data.numel(), _STAGING):
                    n = min(_STAGING, data.numel() - off)
                    staging[:n].copy_(data[off:off + n])
                    fh.write(staging[:n].numpy().data)


def _npz_members(path: str) -> dict:
    """{key: ZipInfo} of an .npz's members (the key without ".npy")."""
    with zipfile.ZipFile(path) as zf:
        return {(i.filename[:-4] if i.filename.endswith(".npy")
                 else i.filename): i for i in zf.infolist()}


def _read_member(fh, info: zipfile.ZipInfo, path: str) -> np.ndarray:
    """One member of the .npz `path` (open as `fh`): a stored .npy of
    format 1.0 or 2.0 (what np.savez and `_write_npz` write), read with
    one np.fromfile at its offset and its CRC-32 checked (np.load reads
    through small buffered reads). A member of any other kind (compressed,
    another .npy format, an object dtype), a short one or a corrupt one
    raises zipfile.BadZipFile."""
    fmt = np.lib.format
    fh.seek(info.header_offset)
    local = fh.read(30)
    if info.compress_type != zipfile.ZIP_STORED or \
            local[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{info.filename} in {path} is not a "
                                 f"stored zip member")
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    start = info.header_offset + 30 + name_len + extra_len
    fh.seek(start)
    try:
        version = fmt.read_magic(fh)
        if version not in ((1, 0), (2, 0)):
            raise ValueError(f".npy format {version}")
        read_header = (fmt.read_array_header_1_0 if version == (1, 0)
                       else fmt.read_array_header_2_0)
        shape, fortran, dtype = read_header(fh)
    except ValueError as e:
        raise zipfile.BadZipFile(f"{info.filename} in {path}: {e}") from e
    head = fh.tell() - start
    count = int(np.prod(shape, dtype=np.int64))
    if dtype.hasobject or head + count * dtype.itemsize != info.file_size:
        raise zipfile.BadZipFile(
            f"{info.filename} in {path}: {dtype} x {shape} after a "
            f"{head}-byte header does not fill its {info.file_size} bytes")
    arr = np.fromfile(fh, dtype=dtype, count=count)
    fh.seek(start)
    crc = zlib.crc32(fh.read(head))
    if arr.size != count or zlib.crc32(
            arr.reshape(-1).view(np.uint8).data, crc) != info.CRC:
        raise zipfile.BadZipFile(f"bad CRC-32 or short data for "
                                 f"{info.filename} in {path}")
    return arr.reshape(shape, order="F" if fortran else "C")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        """Write `tree` (see the module docstring) as step `step`."""
        named = flatten_with_names(tree)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_ckpt_")
        try:
            _write_npz(os.path.join(tmp, "arrays.npz"),
                       [(f"{i:05d}{_SEP}{name}", leaf)
                        for i, (name, leaf) in enumerate(named)])
            manifest = {
                "step": int(step),
                "treedef": _treedef(tree),
                "n_leaves": len(named),
                "extra": extra or {},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                json.dump(manifest, fh)
            # COMMITTED is written (and synced) LAST: its presence means
            # every other file in the dir already hit the disk
            _fsync_file(os.path.join(tmp, "arrays.npz"))
            _fsync_file(os.path.join(tmp, "manifest.json"))
            with open(os.path.join(tmp, "COMMITTED"), "w") as fh:
                fh.write("ok")
                fh.flush()
                os.fsync(fh.fileno())
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            fsync_dir(self.directory)
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        obs.inc("fault.ckpt_saves")
        return self._step_dir(step)

    # -- restore --------------------------------------------------------------
    def steps(self) -> list[int]:
        """All committed step numbers, ascending."""
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, d, "COMMITTED")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step),
                               "manifest.json")) as fh:
            return json.load(fh)

    def restore(self, like: Any,
                step: Optional[int] = None) -> Tuple[int, Any]:
        """-> (step, tree): the step's leaves (the latest committed step
        by default) in `like`'s structure, each cast to its `like` leaf's
        dtype, and placed on its device where that leaf is a tensor."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{self.directory}")
        likes = [leaf for _, leaf in flatten_with_names(like)]
        path = os.path.join(self._step_dir(step), "arrays.npz")
        members = _npz_members(path)
        keys = sorted(members, key=lambda k: int(k.split(_SEP)[0]))
        if len(keys) != len(likes):
            raise ValueError(f"leaf count mismatch: {len(keys)} in "
                             f"step {step} vs {len(likes)} in `like`")
        with open(path, "rb") as fh:
            leaves = [_from_host(_read_member(fh, members[k], path), ref)
                      for k, ref in zip(keys, likes)]
        return step, unflatten_like(like, leaves)

    def load_raw(self, step: int) -> dict:
        """The step's leaves as a {name: host array} dict."""
        path = os.path.join(self._step_dir(step), "arrays.npz")
        with open(path, "rb") as fh:
            return {key.split(_SEP, 1)[1]: _read_member(fh, info, path)
                    for key, info in _npz_members(path).items()}

    def restore_latest_valid_raw(self) -> Optional[Tuple[int, dict, dict]]:
        """Newest checkpoint that actually LOADS, as (step, raw leaves,
        manifest extra): a committed step whose arrays were later
        corrupted is skipped with a warning. None when nothing
        restores."""
        for step in reversed(self.steps()):
            try:
                leaves = self.load_raw(step)
                meta = self.manifest(step).get("extra", {})
                return step, leaves, meta
            except Exception as e:  # zip/OSError/KeyError/json errors
                obs.inc("fault.ckpt_unreadable")
                print(f"[fault] checkpoint step {step} unreadable "
                      f"({type(e).__name__}: {e}); trying older one")
        return None

    # -- internals --------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        # clean stale tmp dirs from crashed writers
        for d in os.listdir(self.directory):
            if d.startswith(".tmp_ckpt_"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)


def _key_of(gen_bytes: bytes) -> np.ndarray:
    """A (2,) uint32 PRNG key for the reference, derived from the
    generator state (distinct per snapshot, deterministic)."""
    return np.frombuffer(hashlib.blake2b(gen_bytes, digest_size=8).digest(),
                         np.uint32).copy()


def host_state(backend, state) -> dict:
    """The host image of an `EngineState`: the reference's four leaves."""
    return {
        "w": backend.host_weights(state.w),
        "z": backend.host_margins(state.z),
        "active": backend.host_active(state.active),
        "key": _key_of(state.gen.get_state().numpy().tobytes()),
    }


def _encode_gen(gen: torch.Generator) -> str:
    return base64.b64encode(gen.get_state().numpy().tobytes()).decode()


def _decode_gen(text: str) -> torch.Tensor:
    return torch.frombuffer(bytearray(base64.b64decode(text)),
                            dtype=torch.uint8)


class SolveCheckpointer:
    """Periodic EngineState snapshots for solves and path sweeps.

    `every` applies to the per-iteration solve callback; the path driver
    checkpoints at every grid-point boundary (a point is the natural
    resume unit: resuming mid-point would replay a partial iteration
    stream).
    """

    KIND_SOLVE = "solve"
    KIND_PATH = "path"

    def __init__(self, directory: str, every: int = 10, keep: int = 3):
        if every < 1:
            raise ValueError(f"ckpt every must be >= 1, got {every}")
        self.manager = CheckpointManager(directory, keep=keep)
        self.every = int(every)

    # -- single solves -------------------------------------------------------
    def save_solve(self, backend, state, *, outer_iter: int,
                   extra: Optional[dict] = None) -> Optional[str]:
        """Every rank of a sharded backend calls this (the host image
        gathers over the mesh); rank 0 alone writes (None elsewhere)."""
        meta = {"kind": self.KIND_SOLVE, "outer_iter": int(outer_iter),
                **(extra or {}), GEN_STATE: _encode_gen(state.gen)}
        tree = host_state(backend, state)
        if not getattr(backend, "is_writer", True):
            return None
        return self.manager.save(int(outer_iter), tree, extra=meta)

    def restore_solve(self, backend):
        """-> (EngineState on the backend, meta dict) or None."""
        got = self._restore(self.KIND_SOLVE)
        if got is None:
            return None
        tree, meta = got
        return backend.restore_state(**tree, gen_state=_gen(meta)), meta

    def latest_meta(self) -> Optional[dict]:
        step = self.manager.latest_step()
        if step is None:
            return None
        return self.manager.manifest(step).get("extra", {})

    def solve_callback(self, backend, **extra) -> Callable:
        """The engine `state_callback`: checkpoint every `every`-th
        finished (finite) iteration."""
        def cb(k: int, state, f: float, kkt: float) -> None:
            if (k + 1) % self.every:
                return
            self.save_solve(backend, state, outer_iter=k,
                            extra={"objective": float(f),
                                   "kkt": float(kkt), **extra})
        return cb

    # -- path sweeps ---------------------------------------------------------
    def save_path(self, backend, state, *, point_index: int, cs, c_max,
                  points, weights,
                  extra: Optional[dict] = None) -> Optional[str]:
        tree = {**host_state(backend, state),
                "weights": np.asarray(weights)}
        if not getattr(backend, "is_writer", True):
            return None
        meta = {"kind": self.KIND_PATH, "point_index": int(point_index),
                "c_max": float(c_max),
                "cs": [float(c) for c in np.asarray(cs)],
                "points": [dict(p._asdict()) for p in points],
                **(extra or {}), GEN_STATE: _encode_gen(state.gen)}
        return self.manager.save(int(point_index), tree, extra=meta)

    def restore_path(self, backend, *, cs, c_max):
        """-> (EngineState, meta, weights) or None. Validates the stored
        c-grid against the live one: a checkpoint from a different
        dataset or grid fails loudly instead of resuming onto wrong
        points."""
        got = self._restore(self.KIND_PATH)
        if got is None:
            return None
        tree, meta = got
        stored = np.asarray(meta["cs"], np.float64)
        live = np.asarray(cs, np.float64)
        if stored.shape != live.shape or not np.allclose(
                stored, live, rtol=1e-9, atol=0.0):
            raise ValueError(
                f"checkpoint in {self.manager.directory} was written for "
                f"a different c-grid ({stored.shape[0]} points, "
                f"c_max={meta['c_max']:.6g}) than this sweep "
                f"({live.shape[0]} points, c_max={float(c_max):.6g}); "
                f"point a fresh --ckpt-dir at this run")
        weights = tree.pop("weights")
        state = backend.restore_state(**tree, gen_state=_gen(meta))
        obs.inc("fault.resumes")
        return state, meta, np.asarray(weights)

    # -- shared --------------------------------------------------------------
    def _restore(self, kind: str):
        got = self.manager.restore_latest_valid_raw()
        if got is None:
            return None
        _step, leaves, meta = got
        if meta.get("kind") != kind:
            raise ValueError(
                f"checkpoint in {self.manager.directory} is a "
                f"{meta.get('kind')!r} checkpoint, not {kind!r} -- solve "
                f"and path runs need separate --ckpt-dir directories")
        return leaves, meta


def _gen(meta: dict) -> Optional[torch.Tensor]:
    text = meta.get(GEN_STATE)
    return None if text is None else _decode_gen(text)
