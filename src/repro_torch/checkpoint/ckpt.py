"""Checkpointing with manifest + async save + restart.

Port of the JAX package's ``repro/checkpoint/ckpt.py``, in the same on-disk
format, so checkpoints cross over in both directions:
``<dir>/step_<N>/arrays.npz`` (``/``-joined leaf path -> array) and
``manifest.json`` (step, leaf index, dtypes, optional metadata), written
under ``step_<N>.tmp`` and renamed into place (a killed save never corrupts
the restore source; ``.tmp`` dirs are ignored).

The port's trees are dicts of tensors with the layers in a list where the
reference stacks them on a leading dim (``repro_torch.tree``): a list is
saved as the stack of its items under one path, as the reference stores its
scanned layers, and restored by splitting that dim. bfloat16 tensors are widened to float32 on
the host (npz has no bfloat16; lossless) and cast back per leaf on restore,
which copies into the tensors of a tree in place (``restore_into``) from a
map of the file.

A state held as slices across data-parallel ranks (FSDP, ``specs`` and a
``mesh`` as ``distributed.sharding.shard_tree`` takes them) is saved whole:
every rank joins the gather and rank 0 writes. A restore copies each rank's
slice of every array into its tensors (of a leaf placed on its layer list,
the rank's layers), so a checkpoint of W ranks restores
at any other W, one process included, and the other way round.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import mmap
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import torch

from repro_torch.distributed import sharding as shd
from repro_torch.tree import flat_paths, list_depth, stack, tree_map


@torch.no_grad()
def _to_host(leaf) -> np.ndarray:
    """A tensor (or a list of tensors, stacked on their own device: one host
    copy of the stack, not one per item) as an owned host array: the saved
    copy must not alias a tensor that the next step updates in place."""
    t = stack(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:  # npz can't hold bf16: widen (lossless)
        t = t.float()
    return t.numpy()


def host_arrays(tree, specs=None, mesh=None):
    """``tree`` as the reference's flat ``path -> array`` dict, on the host.
    With ``specs`` (per top-level key of ``tree``) the placed subtrees are
    gathered whole first (a collective: every rank calls it), and only rank
    0 gets the arrays; the others get None."""
    if specs is not None:
        tree = {k: shd.gather_tree(v, specs[k], mesh) if k in specs else v
                for k, v in tree.items()}
        if not shd.is_first(mesh):
            return None
    return {k: _to_host(v) for k, v in flat_paths(tree).items()}


def _write(directory: str, step: int, arrays: dict, metadata: dict | None) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                   for k, a in arrays.items()},
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree, *, metadata: dict | None = None, specs=None,
         mesh=None) -> str | None:
    """Synchronous atomic save. Returns the final checkpoint path (None on
    the ranks other than 0 of a placed tree, which only join the gather)."""
    arrays = host_arrays(tree, specs, mesh)
    return None if arrays is None else _write(directory, step, arrays, metadata)


class AsyncSaver:
    """Background saves (one in flight; newer wins). ``save`` copies the
    tree to host memory on the caller's thread before the thread starts:
    the port's training step updates its tensors in place, so a thread that
    read live tensors would save a torn state. A save that failed raises
    from the next ``save`` or ``wait``."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, directory: str, step: int, tree, *, specs=None, mesh=None, **kw) -> None:
        """A placed tree (``specs``, ``mesh``) is gathered on every rank
        and written by rank 0."""
        arrays = host_arrays(tree, specs, mesh)
        self.wait()
        if arrays is None:
            return

        def run():
            try:
                _write(directory, step, arrays, kw.get("metadata"))
            except BaseException as exc:  # reported by wait()
                self._error = exc

        self._thread = threading.Thread(target=run)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


@contextlib.contextmanager
def _npz_arrays(path: str):
    """The arrays of an ``.npz`` by name, for the time of the context. A
    stored member (``np.savez`` stores them all) is a view of a
    copy-on-write map of the file, read from the page cache when it is used
    and never through the zip stream; the map goes with its last view. Any
    other member is read by ``numpy.lib.format``."""
    arrays = {}
    with open(path, "rb") as fh, zipfile.ZipFile(fh) as zf:
        mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_COPY)
        for zi in zf.infolist():
            name = zi.filename[:-4] if zi.filename.endswith(".npy") else zi.filename
            arrays[name] = _stored_array(mm, zi)
            if arrays[name] is None:
                with zf.open(zi) as f:
                    arrays[name] = np.lib.format.read_array(f)
    del mm
    try:
        yield arrays
    finally:
        arrays.clear()


def _stored_array(mm: mmap.mmap, zi: zipfile.ZipInfo):
    """A view of a stored C-order ``.npy`` member in ``mm``, or None."""
    if zi.compress_type != zipfile.ZIP_STORED:
        return None
    at = zi.header_offset  # local header: 30 bytes, the name, the extra field
    if mm[at:at + 4] != b"PK\x03\x04":
        raise ValueError(f"{zi.filename}: no local file header at {at}")
    at += 30 + int.from_bytes(mm[at + 26:at + 28], "little") \
        + int.from_bytes(mm[at + 28:at + 30], "little")
    head = io.BytesIO(mm[at:at + min(zi.file_size, 1 << 16)])
    version = np.lib.format.read_magic(head)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(head)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(head)
    else:
        return None
    if fortran or dtype.hasobject:
        return None
    count = math.prod(shape)
    return np.frombuffer(mm, dtype, count, at + head.tell()).reshape(shape)


def _copy_into(leaf, arr: np.ndarray, path: str) -> None:
    """``arr`` into ``leaf`` in place (cast to its dtype, on its device); a
    list takes the items of the leading dim, but for its None items (those
    of another rank, ``sharding.shard_lists``)."""
    if isinstance(leaf, list):
        if arr.shape[:1] != (len(leaf),):
            raise ValueError(f"{path}: checkpoint shape {arr.shape}, {len(leaf)} items")
        for i, x in enumerate(leaf):
            if x is not None:
                _copy_into(x, arr[i], path)
        return
    if tuple(arr.shape) != tuple(leaf.shape):
        raise ValueError(f"{path}: checkpoint shape {arr.shape}, leaf shape {tuple(leaf.shape)}")
    with torch.no_grad():
        leaf.copy_(torch.from_numpy(arr))


def restore_into(directory: str, tree, *, step: int | None = None, specs=None,
                 mesh=None) -> int:
    """Copy the checkpoint of ``step`` (default: the latest) into the
    tensors of ``tree`` in place, each cast to its own dtype on its own
    device, one path at a time; its structure and shapes must match.
    Returns the step. A trainer restores into the state it allocated, with
    no second copy of it on the device. With ``specs`` (per top-level key
    of ``tree``) the placed subtrees hold this rank's slices, and each takes
    its slice of the whole array (a leaf placed on its layer list: the
    items that the rank holds)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    like = flat_paths(tree)
    placed = {}
    if specs is not None:
        for k, v in specs.items():
            placed.update({f"{k}/{p}": s for p, s in flat_paths(v).items()})
    axes = [] if mesh is None else [
        (shd.data_dim, shd.data_extent(mesh), shd.rank_of(mesh)),
        (shd.model_dim, shd.model_extent(mesh), shd.model_rank(mesh))]
    with _npz_arrays(os.path.join(directory, f"step_{step:08d}", "arrays.npz")) as arrays:
        missing = set(like) - set(arrays)
        if missing:
            raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]} ...")
        for k, leaf in like.items():
            arr = arrays[k]
            for dim_of, n_ranks, r in axes:
                d = dim_of(placed[k], mesh) if k in placed and n_ranks > 1 else None
                if d is not None and d >= list_depth(leaf):  # a list dim: the items held
                    n = arr.shape[d] // n_ranks
                    arr = np.take(arr, range(r * n, (r + 1) * n), axis=d)
            _copy_into(leaf, arr, k)
    return step


def restore(directory: str, tree_like, *, step: int | None = None):
    """Restore into the structure, dtypes and devices of ``tree_like`` (left
    as it is). Returns (tree, step)."""
    tree = tree_map(lambda x, stacked: torch.empty_like(x), tree_like)
    return tree, restore_into(directory, tree, step=step)
