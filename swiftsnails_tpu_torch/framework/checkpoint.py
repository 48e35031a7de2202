"""Verified checkpoints — the JAX package's ``framework/checkpoint.py``, with
PyTorch inside.

The reference's checkpointing is write-only: periodic text dumps of every
shard every ``param_backup_period`` pushes (``src/core/system/server/init.h:128-149``)
and no load path. Here, as in the JAX package:

* :func:`save_checkpoint` writes ``param_backup_root/step_<n>/``, committed
  by a manifest (``manifest.json``, atomic tmp+rename) carrying the step,
  the config hash, a CRC of every tensor and the data-stream cursor; a step
  directory without a committed manifest is a torn save. ``wait=False``
  returns once the tensors' copies to the host are enqueued; a writer
  thread waits for them, computes the CRCs, writes the files and commits
  the manifest. It is joined at the next save and by
  :func:`wait_for_checkpoints`, which returns its errors. With a ``ledger``
  each commit appends a ``checkpoint`` event (the steps ``resume: auto``
  prefers) and each write or prune error a ``cache_error`` event.
* :func:`restore_checkpoint` reads a step back into a template state and
  verifies every tensor's bytes against the manifest before it copies any
  of them (:class:`CheckpointError` on a mismatch: corrupt bytes never
  train, and a rejected step leaves the template as it was).
* :func:`load_tables` — the serving plane's template-less restore: every
  tensor of the newest step that verifies, rebuilt from the manifest's
  ``shape`` and ``dtype`` and nested by canonical key, on the caller's
  device (default: the card).
* :func:`prune_checkpoints` — ``param_backup_keep`` retention, never the
  protected (restored-from) step and never the newest one.
* :func:`export_table_text` — ``key<TAB>value`` text rows
  (``SparseTableShard::operator<<``, ``sparsetable.h:49-56``).

**On disk.** One file a tensor, ``<key with / as .>.bin``, holding its raw
bytes in row-major order: the bytes ``np.asarray(x).tobytes()`` gives for
the same array in the JAX package, so one state has the same CRCs in both
packages. Nothing is unpickled on restore. The manifest follows the JAX
schema (``MANIFEST_SCHEMA`` 1): ``step``, ``ts``, ``config_hash``,
``data_cursor`` ``{"step", "items"}``, and for each tensor, under its
canonical key (``in_table/table``), ``crc``, ``algo``, ``shape`` and
``dtype`` (numpy's names: ``float32``, ``bfloat16``, ``int32``). The CRC
is CRC32C when ``google_crc32c`` imports, else zlib's CRC32, and the
manifest says which. The port has no legacy format: a step without a
committed manifest is never restored.

The tables change in place: the row kernels and the fused kernels write
them inside the next step. So a save first enqueues the copy of every CUDA
tensor into pinned host buffers on the current stream (the next step's
kernels queue behind it) and records an event that the writer waits on;
a CPU tensor is cloned. The pinned buffers are reused from save to save.

"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from swiftsnails_tpu_torch.telemetry.ledger import atomic_write_json
from swiftsnails_tpu_torch.utils.device import DeviceLike, resolve_device
from swiftsnails_tpu_torch.utils.tree import tensor_items

_STEP_RE = re.compile(r"^step_(\d+)$")

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = 1

class CheckpointError(Exception):
    """A checkpoint failed verification (manifest mismatch / corrupt bytes)."""


def _step_dir(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step}")


def _array_file(key: str) -> str:
    return key.replace("/", ".") + ".bin"


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _shape(t: torch.Tensor) -> List[int]:
    """The shape a manifest records: the JAX package records
    ``np.ascontiguousarray(x).shape``, which makes a 0-d array ``[1]``."""
    return list(t.shape) or [1]


def _raw_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bytes in row-major order, as a uint8 array (a view
    where the tensor is contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8).numpy()


# ------------------------------------------------------------- manifest ---


def _crc32c(data) -> Tuple[int, str]:
    """CRC of ``data`` (bytes or a uint8 array): CRC32C (Castagnoli) when
    google_crc32c is available, zlib CRC32 otherwise — the algorithm used is
    recorded in the manifest so verification always replays the right one."""
    try:
        import google_crc32c

        return int(google_crc32c.value(data)), "crc32c"
    except ImportError:
        import zlib

        return int(zlib.crc32(data)), "crc32"


def _array_record(t: torch.Tensor) -> Dict:
    crc, algo = _crc32c(_raw_bytes(t.cpu()))
    return {"crc": crc, "algo": algo, "shape": _shape(t), "dtype": _dtype_name(t)}


_KEY_TOKEN_RE = re.compile(r"\['([^']*)'\]|\.([A-Za-z_0-9]+)|\[(\d+)\]")


def canonical_key(keystr: str) -> str:
    """Layout-independent form of a keypath string.

    The JAX package records ``jax.tree_util.keystr`` paths
    (``['in_table'].table``, ``.in_table.table``); both normalize to
    ``in_table/table``, the form the port records. A key already in that
    form comes back unchanged.
    """
    tokens = _KEY_TOKEN_RE.findall(keystr)
    if not tokens:
        return keystr
    return "/".join(a or b or c for a, b, c in tokens)


def _manifest(arrays: Dict, step: int, cursor: Optional[Dict],
              config_hash: Optional[str]) -> Dict:
    return {
        "schema": MANIFEST_SCHEMA,
        "step": int(step),
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "config_hash": config_hash,
        "data_cursor": dict(cursor) if cursor else {"step": int(step)},
        "arrays": arrays,
    }


def build_manifest(
    state: Any,
    step: int,
    cursor: Optional[Dict] = None,
    config_hash: Optional[str] = None,
) -> Dict:
    """Checksum manifest of ``state``: per-tensor CRC + shape/dtype, the
    data-stream cursor, and the config hash. Copies every tensor to the
    host."""
    arrays = {key: _array_record(t) for key, t in tensor_items(state)}
    return _manifest(arrays, step, cursor, config_hash)


def read_manifest(root: str, step: int) -> Optional[Dict]:
    """The committed manifest for ``step``, or None (a torn save)."""
    path = os.path.join(_step_dir(root, step), MANIFEST_NAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    return doc if isinstance(doc, dict) else None


def _crc_problem(key: str, data: np.ndarray, meta: Dict) -> Optional[str]:
    """Why ``data`` does not match ``meta``'s CRC, or None."""
    crc, algo = _crc32c(data)
    if algo != meta.get("algo"):
        # manifest written with a different CRC flavor than this host
        # computes — replay the recorded one via zlib when possible
        if meta.get("algo") != "crc32":
            return f"{key}: crc algorithm {meta.get('algo')!r} unavailable"
        import zlib

        crc = int(zlib.crc32(data))
    if int(crc) != int(meta.get("crc", -1)):
        return f"{key}: crc mismatch (corrupt bytes)"
    return None


def verify_state(state: Any, manifest: Dict) -> List[str]:
    """Problems found comparing ``state``'s bytes against ``manifest``
    (empty list = intact). Accepts the JAX package's manifests: their keys
    are compared in canonical form (:func:`canonical_key`)."""
    problems: List[str] = []
    recorded = manifest.get("arrays")
    if not isinstance(recorded, dict) or not recorded:
        return ["manifest has no array records"]
    canon = {canonical_key(k): v for k, v in recorded.items()}
    seen = set()
    for key, t in tensor_items(state):
        meta = canon.get(key)
        seen.add(key)
        if meta is None:
            problems.append(f"{key}: not in manifest")
            continue
        if _shape(t) != list(meta.get("shape", [])):
            problems.append(f"{key}: shape {_shape(t)} != manifest {meta.get('shape')}")
            continue
        problem = _crc_problem(key, _raw_bytes(t.cpu()), meta)
        if problem:
            problems.append(problem)
    for key in sorted(set(canon) - seen):
        problems.append(f"{key}: in manifest but absent from restored state")
    return problems


# ------------------------------------------------------------------ save ---

# The writer: one thread at a time, joined before the next save. Its write
# errors accumulate in _ckpt_errors until wait_for_checkpoints() collects
# them. Guarded by _lock.
_lock = threading.RLock()
_writer: Optional[threading.Thread] = None
_ckpt_errors: List[str] = []
_pinned: Dict[str, torch.Tensor] = {}  # reused host buffers of CUDA tensors, by key


def _note_error(msg: str, ledger=None) -> None:
    with _lock:
        _ckpt_errors.append(msg)
    if ledger is not None:
        try:
            ledger.append("cache_error", {"source": "checkpoint", "error": msg})
        except Exception:
            pass  # record-keeping never blocks the save path


def _to_host(state: Any) -> Tuple[List[Tuple[str, torch.Tensor]], Optional[torch.cuda.Event]]:
    """Host copies of every tensor of ``state``: CUDA tensors enqueued into
    pinned buffers on the current stream (the returned event completes with
    them), CPU tensors cloned."""
    out, on_card = [], False
    for key, t in tensor_items(state):
        if t.device.type == "cuda":
            buf = _pinned.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = _pinned[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            on_card = True
        else:
            buf = t.detach().clone(memory_format=torch.contiguous_format)
        out.append((key, buf))
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return out, event


def _write_step(entry: Dict) -> None:
    """The writer thread's body: wait for the host copies, CRC, write every
    file (fsync'd), commit the manifest, apply retention. Failures are
    recorded, never raised."""
    path = entry["path"]
    try:
        t0 = time.perf_counter()
        if entry["event"] is not None:
            entry["event"].synchronize()
        t1 = time.perf_counter()
        arrays, payload = {}, []
        for key, host in entry["host"]:
            data = _raw_bytes(host)
            crc, algo = _crc32c(data)
            arrays[key] = {"crc": crc, "algo": algo, "shape": _shape(host),
                           "dtype": _dtype_name(host)}
            payload.append((_array_file(key), data))
        t2 = time.perf_counter()

        def write_files():
            if os.path.isdir(path):  # a save of this step again: drop the old one first
                shutil.rmtree(path)
            os.makedirs(path)
            for name, data in payload:
                with open(os.path.join(path, name), "wb") as f:
                    f.write(data)
                    f.flush()
                    os.fsync(f.fileno())

        retry = entry["retry"]
        if retry is not None:
            retry.call(write_files, op=f"ckpt_save:step_{entry['step']}")
        else:
            write_files()
        manifest = _manifest(arrays, entry["step"], entry["cursor"], entry["config_hash"])
        atomic_write_json(os.path.join(path, MANIFEST_NAME), manifest)
        t3 = time.perf_counter()
        ledger = entry["ledger"]
        if ledger is not None:
            try:
                ledger.append("checkpoint", {
                    "root": os.path.abspath(entry["root"]),
                    "step": manifest["step"],
                    "config_hash": manifest.get("config_hash"),
                    "data_cursor": manifest.get("data_cursor"),
                })
            except Exception:
                pass  # record-keeping never blocks the save path
        nbytes = sum(d.nbytes for _, d in payload)
        print(f"checkpoint: committed step_{entry['step']} ({nbytes} bytes: "
              f"snapshot {entry['snapshot_s']:.4f} s, d2h wait {t1 - t0:.4f} s, "
              f"crc {t2 - t1:.4f} s, write {t3 - t2:.4f} s)", file=sys.stderr)
    except Exception as e:  # a failed save must not take down the training loop
        _note_error(f"checkpoint save failed for {path}: {type(e).__name__}: {e}",
                    entry["ledger"])
        return
    if entry["keep"] > 0:
        try:
            prune_checkpoints(entry["root"], entry["keep"], protect=entry["protect"],
                              ledger=entry["ledger"])
        except OSError as e:
            _note_error(f"retention prune failed under {entry['root']}: {e}",
                        entry["ledger"])


def _join_writer() -> None:
    global _writer
    with _lock:
        writer, _writer = _writer, None
    if writer is not None:
        writer.join()


def save_checkpoint(
    root: str,
    state: Any,
    step: int,
    wait: bool = True,
    cursor: Optional[Dict] = None,
    config_hash: Optional[str] = None,
    keep: int = 0,
    protect: Optional[int] = None,
    retry=None,
    ledger=None,
    tier=None,
) -> str:
    """Write a checkpoint of ``state`` for ``step`` under ``root``, committed
    by a checksum manifest; returns the step directory.

    ``wait=False`` returns once the host copies are enqueued; the writer
    thread commits the manifest when the files are written, and the next
    save or :func:`wait_for_checkpoints` joins it. ``cursor`` is the
    data-stream position (at least ``{"step": N}``) that ``resume: auto``
    continues from. ``keep > 0`` applies ``param_backup_keep`` retention
    after the commit; ``protect`` is a step never pruned (the step this run
    restored from). ``retry`` (a :class:`~swiftsnails_tpu_torch.resilience.retry.RetryPolicy`)
    absorbs transient ``OSError`` of the file writes. ``ledger`` (a
    :class:`~swiftsnails_tpu_torch.telemetry.ledger.Ledger`) receives the
    commit's ``checkpoint`` event and any ``cache_error``.

    ``tier`` (a :class:`~swiftsnails_tpu_torch.tiered.TierManager`) makes the
    save tier-transparent: the background flush queue is drained and every
    dirty cache slot flushed host-ward FIRST (flush-before-manifest), the
    full-size master-backed state is what gets written (on-disk format
    identical to a resident run's, so restore and serving need no tier
    awareness), and the save is synchronous — the masters are numpy arrays
    that later eviction flushes mutate in place.
    """
    global _writer
    if tier is not None:
        state = tier.master_state(state)
        wait = True
    _join_writer()  # one save at a time: its buffers are about to be reused
    t0 = time.perf_counter()
    host, event = _to_host(state)
    entry = {"root": root, "path": _step_dir(root, step), "step": int(step),
             "cursor": cursor, "config_hash": config_hash, "keep": keep,
             "protect": protect, "retry": retry, "ledger": ledger,
             "host": host, "event": event,
             "snapshot_s": time.perf_counter() - t0}
    writer = threading.Thread(target=_write_step, args=(entry,),
                              name=f"checkpoint-step_{step}")
    with _lock:
        _writer = writer
    writer.start()
    if wait:
        wait_for_checkpoints()
    return entry["path"]


def wait_for_checkpoints() -> List[str]:
    """Join the in-flight checkpoint write (its manifest is then committed
    or its failure recorded) and return, clearing, the accumulated
    write-error descriptions."""
    _join_writer()
    with _lock:
        errors = list(_ckpt_errors)
        _ckpt_errors.clear()
    return errors


# ------------------------------------------------------------- discovery ---


def all_steps(root: str) -> List[int]:
    """Every ``step_*`` dir under ``root``, ascending (committed or torn)."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(root: str) -> Optional[int]:
    """Newest checkpoint step under ``root``, or None."""
    steps = all_steps(root)
    return steps[-1] if steps else None


def intact_steps(root: str) -> List[int]:
    """Steps with a committed (parseable) manifest, newest first."""
    return [s for s in reversed(all_steps(root)) if read_manifest(root, s)]


def candidate_steps(root: str, preferred: Sequence[int] = ()) -> List[int]:
    """Restore candidates under ``root``, best first: steps with a committed
    manifest outrank torn dirs of any age, newer outranks older within each
    tier. ``preferred`` seeds the list but never adds steps that are not on
    disk."""
    disk = list(reversed(all_steps(root)))  # newest first, torn dirs included
    if not disk:
        return []
    on_disk = set(disk)
    candidates: List[int] = [s for s in preferred if s in on_disk]
    candidates.extend(s for s in disk if s not in candidates)
    intact = set(intact_steps(root))
    candidates.sort(key=lambda s: (s in intact, s), reverse=True)
    return candidates


# -------------------------------------------------------------- retention ---


def prune_checkpoints(root: str, keep: int, protect: Optional[int] = None,
                      ledger=None) -> List[int]:
    """``param_backup_keep`` retention: keep the newest ``keep`` *intact*
    steps (plus the newest step of any kind, plus ``protect`` — the step a
    resumed run restored from is never deleted under it). Returns the pruned
    steps."""
    if keep <= 0:
        return []
    steps = all_steps(root)
    if not steps:
        return []
    intact = intact_steps(root)
    protected = set(intact[:keep])
    protected.add(steps[-1])  # the newest dir may still be committing
    if protect is not None:
        protected.add(int(protect))
    pruned = []
    for s in steps:
        if s in protected:
            continue
        try:
            shutil.rmtree(_step_dir(root, s))
            pruned.append(s)
        except OSError as e:
            _note_error(f"prune of step_{s} under {root} failed: {e}", ledger)
    return pruned


# --------------------------------------------------------------- restore ---


def restore_checkpoint(
    root: str,
    state_template: Any,
    step: Optional[int] = None,
    verify: bool = True,
) -> Any:
    """Restore ``step`` (default: the newest) into ``state_template`` and
    return it.

    The template (a freshly initialized state) gives the structure, the
    devices and the dtypes; its tensors are overwritten in place, so a
    restore needs no second copy of the tables on the card. Every file is
    read and, with ``verify`` (default), checked against the manifest's CRC
    before any tensor is written: a mismatch raises :class:`CheckpointError`
    and leaves the template as it was. A step without a committed manifest,
    or whose shapes, dtypes or keys differ from the template's, raises
    :class:`CheckpointError` too. Callers that must survive corruption walk
    back via :func:`swiftsnails_tpu_torch.resilience.resume.resume_state`.
    """
    wait_for_checkpoints()  # never read past an in-flight save
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, step)
    manifest = read_manifest(root, step)
    if manifest is None or not isinstance(manifest.get("arrays"), dict):
        raise CheckpointError(f"{path}: no committed manifest (a torn save)")
    canon = {canonical_key(k): v for k, v in manifest["arrays"].items()}
    items = tensor_items(state_template)
    if {key for key, _ in items} != set(canon):
        raise CheckpointError(
            f"{path}: keys {sorted(canon)} differ from the template's "
            f"{sorted(key for key, _ in items)}")
    problems, loaded = [], []
    for key, t in items:
        meta = canon[key]
        if _shape(t) != list(meta.get("shape", [])) or _dtype_name(t) != meta.get("dtype"):
            raise CheckpointError(
                f"{path}: {key} is {meta.get('dtype')}{meta.get('shape')} on disk, "
                f"{_dtype_name(t)}{_shape(t)} in the template")
        data = np.fromfile(os.path.join(path, _array_file(key)), dtype=np.uint8)
        if data.nbytes != t.numel() * t.element_size():
            problems.append(f"{key}: {data.nbytes} bytes on disk, want "
                            f"{t.numel() * t.element_size()}")
            continue
        if verify:
            problem = _crc_problem(key, data, meta)
            if problem:
                problems.append(problem)
                continue
        loaded.append((t, data))
    if problems:
        raise CheckpointError(f"{path}: manifest verification failed: " + "; ".join(problems[:4]))
    with torch.no_grad():
        for t, data in loaded:
            t.copy_(torch.from_numpy(data).view(t.dtype).reshape(t.shape))
    return state_template


def _read_step(root: str, step: int) -> Tuple[Dict, List[Tuple[str, np.ndarray, Dict]]]:
    """``(manifest, [(key, bytes, record), ...])`` of a committed step: every
    tensor file read whole. Raises :class:`CheckpointError` for a torn save
    and ``OSError`` for a file that cannot be read."""
    path = _step_dir(root, step)
    manifest = read_manifest(root, step)
    if manifest is None or not isinstance(manifest.get("arrays"), dict) \
            or not manifest["arrays"]:
        raise CheckpointError(f"{path}: no committed manifest (a torn save)")
    files = []
    for key, meta in manifest["arrays"].items():
        key = canonical_key(key)
        data = np.fromfile(os.path.join(path, _array_file(key)), dtype=np.uint8)
        files.append((key, data, meta))
    return manifest, files


def _tensor_from_bytes(key: str, data: np.ndarray, meta: Dict) -> torch.Tensor:
    """The tensor a manifest record describes, over ``data`` (its raw
    bytes). numpy has no bfloat16: the bytes are viewed as torch's."""
    try:
        dtype = getattr(torch, str(meta.get("dtype")))
    except AttributeError:
        dtype = None
    if not isinstance(dtype, torch.dtype):
        raise CheckpointError(f"{key}: unknown dtype {meta.get('dtype')!r}")
    shape = [int(n) for n in meta.get("shape", [])]
    want = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    if data.nbytes != want:
        raise CheckpointError(f"{key}: {data.nbytes} bytes on disk, want {want} "
                              f"for {meta.get('dtype')}{shape}")
    return torch.from_numpy(data).view(dtype).reshape(shape)


def _nest(items: List[Tuple[str, torch.Tensor]]) -> Dict[str, Any]:
    """``[("table/table", t), ...]`` -> ``{"table": {"table": t}}``."""
    tree: Dict[str, Any] = {}
    for key, t in items:
        node = tree
        *parents, leaf = key.split("/")
        for name in parents:
            node = node.setdefault(name, {})
        node[leaf] = t
    return tree


def load_tables(
    root: str,
    step: Optional[int] = None,
    verify: bool = True,
    retry=None,
    device: DeviceLike = None,
) -> Tuple[Dict[str, Any], Dict]:
    """Query-only restore: ``(state_tree, manifest)`` with no trainer needed.

    :func:`restore_checkpoint` needs a freshly initialized template; a
    serving process has no trainer, so this rebuilds every tensor from the
    manifest's ``shape`` and ``dtype`` and nests the tree by canonical key
    (``in_table/table`` -> ``tree["in_table"]["table"]``; NamedTuple levels
    become plain dicts, as in the JAX package). A 0-d tensor comes back as
    ``[1]``, the shape its manifest records. With ``verify`` (default)
    every tensor's CRC is checked before any tensor is returned. With
    ``step=None`` the candidates are walked best first
    (:func:`candidate_steps`) and the newest step that reads and verifies
    wins; a torn or corrupt step is passed over, and if none survives every
    rejection is collected into one :class:`CheckpointError`. ``retry`` (a
    :class:`~swiftsnails_tpu_torch.resilience.retry.RetryPolicy`) absorbs
    transient storage errors of a step's reads. The tensors go to
    ``device`` (default: the card).
    """
    wait_for_checkpoints()  # never read past an in-flight save
    dev = resolve_device(device)
    steps = [int(step)] if step is not None else candidate_steps(root)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {root}")
    rejections: List[str] = []
    for s in steps:
        try:
            if retry is not None:
                manifest, files = retry.call(_read_step, root, s,
                                             op=f"ckpt_load:step_{s}")
            else:
                manifest, files = _read_step(root, s)
            problems = [p for key, data, meta in files
                        if (p := _crc_problem(key, data, meta))] if verify else []
            if problems:
                raise CheckpointError("manifest verification failed: "
                                      + "; ".join(problems[:4]))
            tensors = [(key, _tensor_from_bytes(key, data, meta))
                       for key, data, meta in files]
        except Exception as e:  # a step that cannot serve: try the next one
            rejections.append(f"step_{s}: {type(e).__name__}: {e}")
            continue
        return _nest([(key, t.to(dev)) for key, t in tensors]), manifest
    raise CheckpointError(
        f"no restorable checkpoint under {root}: " + " | ".join(rejections[:4]))


def export_table_text(table: torch.Tensor, path_or_file, keys: Optional[np.ndarray] = None,
                      chunk_rows: int = 65536) -> None:
    """Dump table rows as ``key<TAB>v0 v1 ...`` lines (ServerTerminate
    parity), copying ``chunk_rows`` rows at a time to the host."""
    close = False
    if isinstance(path_or_file, (str, os.PathLike)):
        f = open(path_or_file, "w", encoding="utf-8")
        close = True
    else:
        f = path_or_file
    try:
        n = table.shape[0]
        if keys is None:
            keys = np.arange(n, dtype=np.int64)
        for start in range(0, n, chunk_rows):
            stop = min(start + chunk_rows, n)
            block = table[start:stop].float().cpu().numpy()
            for i, row in enumerate(block):
                vals = " ".join(f"{x:.6f}" for x in row)
                f.write(f"{int(keys[start + i])}\t{vals}\n")
    finally:
        if close:
            f.close()
