"""Checkpointing: atomic, keep-N, numpy-backed, in the JAX package's
on-disk format (``repro/checkpoint/manager.py``), so each package reads
the other's float checkpoints.

Layout:
    <dir>/step_000000000123/
        manifest.json            # step, leaf paths, shapes, dtypes
        arrays.npz               # leaf_0, leaf_1, ... (uncompressed)
    <dir>/LATEST                 # text file: last durable step

Leaves are a state's tensors and Python ints, in the JAX package's
order: dict keys sorted, NamedTuple fields and list items in order,
``None`` no leaf.  Paths are written as ``jax.tree_util.keystr`` writes
them (``.opt_state.mu['w']``).  An int leaf (a step, an optimizer count)
is written as an int32 0-d array, as the JAX package's are, and restored
as an int.  A bfloat16 leaf is written as JAX writes it, its bits as a
2-byte void array with ``"bfloat16"`` in ``dtypes`` (numpy has no
bfloat16), and read back through an int16 view, bit for bit.

Guarantees (the JAX package's):
* **Atomicity** — a step is written to ``step_N.tmp``, fsynced, and
  renamed; a crash mid-save never corrupts the latest checkpoint.
* **Keep-N** — older checkpoints are removed after a durable save, and
  stale ``step_*.tmp`` directories left by crashed writers with them.
* **Async** — ``save(..., blocking=False)`` copies every leaf to host
  memory before it returns (the optimizers update their moments in
  place, so the next step must not reach what the writer reads), then
  writes on one background thread; ``wait()`` joins it, so at most one
  save is in flight.  A failure on that thread is re-raised by the next
  ``wait()`` / ``save()`` / ``restore()``.
* **Retry** — only ``OSError`` retries: ``save_retries`` attempts,
  ``retry_backoff·2^k`` sleeps.  The step write and its publication
  (the LATEST pointer and GC) retry apart, so a publication failure
  never removes the durable step.
* **Device** — ``restore(..., device=)`` puts every leaf on one device
  (save on ``cuda``, restore on ``cpu``, and back); without it, each
  leaf goes to its template leaf's device.  Either way a leaf takes its
  template leaf's dtype.

CUDA leaves are copied into page-locked host buffers that the next save
reuses.  Each leaf is written to and read from its zip entry in one
piece (``np.savez`` / ``np.load`` copy in small chunks); every entry's
CRC-32 is written and, on restore, checked.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

_BF16 = "bfloat16"
_VOID2 = np.dtype("V2")           # a bfloat16 leaf's bits on disk


def tree_flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of nested dicts / NamedTuples / lists / tuples,
    in the JAX package's leaf order and ``keystr`` notation."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in tree_flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pair for f in tree._fields
                for pair in tree_flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree)
                for pair in tree_flatten(v, f"{path}[{i}]")]
    if tree is None:
        return []
    return [(path, tree)]


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s structure, its dicts in their own key order, with
    ``leaves`` (in ``tree_flatten``'s order) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    return build(template)


def _as_numpy(x: torch.Tensor) -> np.ndarray:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_VOID2)
    return x.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return _BF16 if arr.dtype == _VOID2 else str(arr.dtype)


def _write_npz(path: str, arrays: list) -> None:
    """An uncompressed npz of ``leaf_i.npy`` entries, as ``np.savez``
    writes it, each array in one write; fsynced."""
    with open(path, "wb") as f:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for i, arr in enumerate(arrays):
                with zf.open(f"leaf_{i}.npy", "w", force_zip64=True) as out:
                    np.lib.format.write_array_header_1_0(
                        out, np.lib.format.header_data_from_array_1_0(arr))
                    out.write(arr.reshape(-1).view(np.uint8))
        f.flush()
        os.fsync(f.fileno())


_READ_HEADER = {(1, 0): np.lib.format.read_array_header_1_0,
                (2, 0): np.lib.format.read_array_header_2_0}


def _read_npz(path: str, count: int,
              pool: concurrent.futures.Executor) -> list:
    """The ``leaf_0 .. leaf_{count-1}`` arrays of an uncompressed npz,
    each read into one buffer; raises if an entry is compressed, short,
    or fails its CRC-32 (checked on ``pool``'s threads)."""
    arrays, checks = [], []
    with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
        for i in range(count):
            info = zf.getinfo(f"leaf_{i}.npy")
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: leaf_{i} is compressed")
            f.seek(info.header_offset + 26)     # the local header's lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            start = info.header_offset + 30 + name_len + extra_len
            f.seek(start)
            shape, fortran, dtype = _READ_HEADER[
                np.lib.format.read_magic(f)](f)
            if fortran:
                raise ValueError(f"{path}: leaf_{i} is in Fortran order")
            head_len = f.tell() - start
            f.seek(start)
            head = f.read(head_len)
            arr = np.empty(shape, dtype)
            data = arr.reshape(-1).view(np.uint8)
            if (head_len + data.nbytes != info.file_size
                    or f.readinto(data) != data.nbytes):
                raise ValueError(f"{path}: leaf_{i} is truncated")
            checks.append((i, info.CRC,
                           pool.submit(zlib.crc32, data, zlib.crc32(head))))
            arrays.append(arr)
    for i, want, got in checks:
        if got.result() != want:
            raise ValueError(f"{path}: leaf_{i} fails its CRC-32 check")
    return arrays


def _leaf(arr: np.ndarray, dtype: str, template: Any, device) -> Any:
    if not isinstance(template, torch.Tensor):
        return type(template)(arr.item())
    t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
         if dtype == _BF16 else torch.from_numpy(arr))
    return t.to(device=device or template.device, dtype=template.dtype)


class CheckpointManager:

    def __init__(self, directory: str, keep: int = 3,
                 save_retries: int = 3, retry_backoff: float = 0.1):
        self.directory = directory
        self.keep = keep
        self.save_retries = max(1, save_retries)
        self.retry_backoff = retry_backoff
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None
        self._pinned: dict[int, torch.Tensor] = {}   # leaf index -> buffer

    def _snapshot(self, leaves: list) -> list:
        """Host copies of ``leaves`` that nothing else references, as
        numpy arrays; CUDA leaves through reused page-locked buffers."""
        copies, devices = [], set()
        for i, x in enumerate(leaves):
            if isinstance(x, int):
                copies.append(np.asarray(x, np.int32))
                continue
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"cannot checkpoint a leaf of type "
                                f"{type(x).__name__}")
            x = x.detach()
            if x.device.type == "cuda":
                buf = self._pinned.get(i)
                if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    self._pinned[i] = buf
                buf.copy_(x, non_blocking=True)
                devices.add(x.device)
            else:
                buf = torch.empty(x.shape, dtype=x.dtype).copy_(x)
            copies.append(buf)
        for dev in devices:
            torch.cuda.synchronize(dev)
        return [_as_numpy(c) if isinstance(c, torch.Tensor) else c
                for c in copies]

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        self.wait()
        pairs = tree_flatten(state)
        paths = [p for p, _ in pairs]
        arrays = self._snapshot([x for _, x in pairs])

        def _write():
            # retryable as a whole: the rename at the end is the
            # durability point
            final = os.path.join(self.directory, f"step_{step:012d}")
            if os.path.exists(final):        # idempotent re-save of a step
                shutil.rmtree(final)
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            _write_npz(os.path.join(tmp, "arrays.npz"), arrays)
            manifest = {"step": step, "paths": paths,
                        "shapes": [list(a.shape) for a in arrays],
                        "dtypes": [_dtype_name(a) for a in arrays]}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)

        def _publish():
            # retryable on its own: the step dir is already durable, and
            # _write's first act would remove it.  (latest_step() falls
            # back to a directory scan, so a stale LATEST is recoverable.)
            pointer = os.path.join(self.directory, "LATEST")
            with open(pointer + ".tmp", "w") as f:
                f.write(str(step))
                f.flush()
                os.fsync(f.fileno())
            os.rename(pointer + ".tmp", pointer)
            self._gc()

        def _retry(fn):
            for attempt in range(self.save_retries):
                try:
                    return fn()
                except OSError:
                    if attempt == self.save_retries - 1:
                        raise
                    time.sleep(self.retry_backoff * (2 ** attempt))

        def _write_with_retry():
            _retry(_write)
            _retry(_publish)

        if blocking:
            _write_with_retry()
        else:
            def _guarded():
                try:
                    _write_with_retry()
                except BaseException as e:  # noqa: BLE001 — re-raised on wait()
                    self._exc = e

            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join any in-flight async save; re-raise its failure if it had
        one (so a failed save cannot be mistaken for a durable one)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def in_flight(self) -> bool:
        """Whether an async save is still writing."""
        return self._thread is not None and self._thread.is_alive()

    def _gc(self) -> None:
        # stale .tmp dirs first (crashed writers); the in-flight save's
        # tmp has been renamed by the time _gc runs
        for d in os.listdir(self.directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, d),
                              ignore_errors=True)
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:012d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list:
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, d,
                                               "manifest.json")):
                    out.append(int(d[len("step_"):]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        # the durable LATEST pointer first; else a directory scan
        p = os.path.join(self.directory, "LATEST")
        if os.path.exists(p):
            with open(p) as f:
                s = int(f.read().strip())
            if os.path.exists(os.path.join(self.directory, f"step_{s:012d}")):
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> tuple[Any, int]:
        """Restore into ``template``'s structure, each leaf in its
        template leaf's dtype, on ``device`` if given (else on its
        template leaf's device).  Raises if the leaf count or a leaf's
        shape differs from the template's."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = os.path.join(self.directory, f"step_{step:012d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        pairs = tree_flatten(template)
        count = len(manifest["paths"])
        if len(pairs) != count:
            raise ValueError(
                f"checkpoint has {count} leaves, template has "
                f"{len(pairs)} — structure changed?")
        for (path, t), shape in zip(pairs, manifest["shapes"]):
            want = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
            if tuple(shape) != want:
                raise ValueError(f"checkpoint leaf {path} has shape "
                                 f"{tuple(shape)}, the template's {want}")
        with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
            arrays = _read_npz(os.path.join(d, "arrays.npz"), count, pool)
        for (path, _), arr, shape in zip(pairs, arrays, manifest["shapes"]):
            if arr.shape != tuple(shape):
                raise ValueError(f"checkpoint leaf {path}: arrays.npz holds "
                                 f"{arr.shape}, the manifest {tuple(shape)}")
        device = None if device is None else torch.device(device)
        leaves = [_leaf(arr, dtype, t, device) for arr, dtype, (_, t)
                  in zip(arrays, manifest["dtypes"], pairs)]
        return tree_unflatten(template, leaves), step
