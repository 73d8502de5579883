"""Checkpoint save/load.

Counterpart of ``deepspeed_tpu/runtime/checkpointing.py``, writing and
reading the same files: a checkpoint written by either package loads into
the other.  The layout is ``<dir>/<tag>/`` plus a ``latest`` tag file and a
``checkpoint_index.json``; every leaf of the train state is one full
``.npy`` named by its key, and ``metadata.json`` holds ``format_version``,
``tag``, a ``manifest`` of ``key``/``shape``/``dtype``/``nbytes``/``crc32``
entries and the ``client_state``.

Leaf keys and order are JAX's: a NamedTuple field or dict key is one part
of the path, the parts are joined by ``.`` and every character outside
``[A-Za-z0-9_.-]`` becomes ``_`` (``params.layers.attn.wq``,
``opt_state.exp_avg.embed``, ``loss_scale.cur_scale``); NamedTuple fields
come in declaration order and dict keys sorted, as ``jax.tree_util``
flattens them.  Python ints in the state (``step``, an optimizer's step, the
loss-scale counters) are written as 0-d ``int32``, Python floats (the loss
scale) as 0-d ``float32``, tensors through ``.detach().cpu().numpy()``; the
manifest's ``dtype`` is numpy's name (``"float32"``).  Loading matches
leaves by key, never by position, so the port's dicts (in insertion order)
and JAX's (sorted) meet leaf for leaf.

Durability protocol: a save stages everything under ``<dir>/.tmp_<tag>/``,
fsyncs each leaf, records its CRC32 and byte size in ``metadata.json`` (read
back from the disk), renames the staging dir to ``<dir>/<tag>/``, calls
``engine.commit(tag)``, and only then flips ``latest``.  A death at any
point leaves ``latest`` on the previous complete checkpoint; stale staging
dirs are swept on the next save.  Loads validate manifest completeness and
sizes (CRC32s too with ``verify_integrity``) and can fall back to the newest
valid earlier tag.

Data-parallel ranks hold identical replicas, so every leaf is whole on
each rank: at a world size above 1 rank 0 alone writes (``on_rank0``), the
others wait for its outcome under a bounded wait (a failed save raises on
every rank), and every rank loads the same files.  Two ranks never write one
file.  The JAX package's streaming of sharded leaves into memmapped files
(``checkpointing.py:398-451``) waits for sharded state (ROADMAP item 11b).
"""

import json
import logging
import os
import re
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils.wal import atomic_write_text, file_crc32, fsync_dir, fsync_file
from .checkpoint_engine import CheckpointEngine, NativeCheckpointEngine

logger = logging.getLogger(__name__)

LATEST_FILE = "latest"
INDEX_FILE = "checkpoint_index.json"
METADATA_FILE = "metadata.json"
TMP_PREFIX = ".tmp_"
FORMAT_VERSION = 1


class CheckpointError(RuntimeError):
    """A checkpoint is missing, incomplete, or corrupt.

    Raised instead of the raw ``FileNotFoundError`` / ``JSONDecodeError`` a
    half-written directory produces, always naming the dir, the tag, and a
    remedy (``fallback_to_valid=True`` walks back to the newest valid tag)."""


# ------------------------------------------------------------------ leaf keys
def _leaf_key(path) -> str:
    key = ".".join(str(p) for p in path)
    return re.sub(r"[^A-Za-z0-9_.\-]", "_", key)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf of ``tree`` in JAX's leaf order:
    NamedTuple fields in declaration order, dict keys sorted; None holds no
    leaf.  ``".".join(map(str, path))`` is the key JAX's ``key_of`` makes
    from ``tree_flatten_with_path`` (``compression/compress.py:81-82``)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], path + (k, ))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from flatten_with_paths(getattr(tree, name), path + (name, ))
    else:
        yield path, tree


def flatten_with_keys(tree) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` of every leaf of ``tree`` in JAX's leaf order, the key
    the dotted path with any character outside ``[A-Za-z0-9_.-]`` made ``_``
    (a file name)."""
    for path, leaf in flatten_with_paths(tree):
        yield _leaf_key(path), leaf


def map_with_keys(fn, tree, path=()):
    """``tree`` rebuilt with every leaf replaced by ``fn(key, leaf)``; dicts
    keep their own key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, path + (k, )) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_keys(fn, getattr(tree, name), path + (name, ))
                            for name in tree._fields))
    return fn(_leaf_key(path), tree)


def to_host(leaf) -> np.ndarray:
    """A state leaf as the numpy array JAX would write for it: tensors as
    they are, Python ints as 0-d int32, Python floats as 0-d float32."""
    if isinstance(leaf, torch.Tensor):
        return np.ascontiguousarray(leaf.detach().cpu().numpy())
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, np.int32)
    if isinstance(leaf, (float, np.floating)):
        return np.asarray(leaf, np.float32)
    return np.ascontiguousarray(np.asarray(leaf))


# staging dirs of saves in flight in THIS process: a reentrant save (the
# SIGTERM preemption handler interrupting a regular save) must not sweep the
# dir the interrupted save is still writing into
_ACTIVE_STAGING: set = set()


def _sweep_stale_tmp(save_dir: str) -> List[str]:
    """Remove ``.tmp_*`` staging dirs left by crashed saves (a staging dir is
    only ever renamed away on success, so any survivor not registered as in
    flight is garbage)."""
    swept = []
    try:
        entries = os.listdir(save_dir)
    except OSError:
        return swept
    for name in entries:
        path = os.path.join(save_dir, name)
        if (name.startswith(TMP_PREFIX) and os.path.isdir(path)
                and path not in _ACTIVE_STAGING):
            shutil.rmtree(path, ignore_errors=True)
            swept.append(name)
    if swept:
        logger.warning(f"swept {len(swept)} stale checkpoint staging dir(s) in "
                       f"{save_dir}: {swept} (crashed earlier save)")
    return swept


# -------------------------------------------------------------- tag bookkeeping
def _read_index(save_dir: str) -> List[str]:
    path = os.path.join(save_dir, INDEX_FILE)
    try:
        with open(path) as fh:
            data = json.load(fh)
        tags = data.get("tags", [])
        return [t for t in tags if isinstance(t, str)]
    except (OSError, ValueError):
        return []


def _write_index(save_dir: str, tags: List[str]) -> None:
    atomic_write_text(os.path.join(save_dir, INDEX_FILE), json.dumps({"tags": tags}, indent=1))


def _append_index(save_dir: str, tag: str) -> None:
    tags = [t for t in _read_index(save_dir) if t != tag]
    tags.append(tag)
    _write_index(save_dir, tags)


def list_tags(load_dir: str) -> List[str]:
    """All checkpoint tags under ``load_dir``, oldest -> newest: in
    ``checkpoint_index.json`` order, then any on-disk tags the index missed
    (hand-copied ones) in mtime order."""
    try:
        on_disk = {d for d in os.listdir(load_dir)
                   if os.path.isdir(os.path.join(load_dir, d)) and not d.startswith(TMP_PREFIX)}
    except OSError:
        return []
    tags = [t for t in _read_index(load_dir) if t in on_disk]
    extra = sorted(on_disk - set(tags), key=lambda t: os.path.getmtime(os.path.join(load_dir, t)))
    return tags + extra


def get_latest_tag(load_dir: str) -> Optional[str]:
    """The tag named by the ``latest`` file; None when there is no
    ``latest``.  An empty or whitespace ``latest`` raises
    :class:`CheckpointError`."""
    path = os.path.join(load_dir, LATEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        tag = fh.read().strip()
    if not tag:
        raise CheckpointError(
            f"checkpoint dir {load_dir!r}: the '{LATEST_FILE}' file is empty/whitespace "
            f"(torn write?) — delete it and pass an explicit tag, or use "
            f"load_checkpoint(..., fallback_to_valid=True) to walk back to the newest "
            f"valid checkpoint")
    return tag


def read_metadata(ckpt_dir: str) -> Dict[str, Any]:
    """Parse ``<ckpt_dir>/metadata.json``; missing or corrupt JSON raises a
    :class:`CheckpointError` naming the dir and the remedy."""
    path = os.path.join(ckpt_dir, METADATA_FILE)
    if not os.path.exists(path):
        raise CheckpointError(
            f"checkpoint {ckpt_dir!r} has no {METADATA_FILE} — incomplete or corrupted "
            f"save; pick another tag or use fallback_to_valid=True")
    try:
        with open(path) as fh:
            return json.load(fh)
    except ValueError as exc:
        raise CheckpointError(
            f"checkpoint {ckpt_dir!r}: {METADATA_FILE} is not valid JSON ({exc}) — "
            f"corrupted save; pick another tag or use fallback_to_valid=True") from exc


def check_checkpoint_tag(load_dir: str, tag: str, verify_integrity: bool = False) -> List[str]:
    """Integrity problems of ``<load_dir>/<tag>/`` (an empty list: valid).

    Always checks that the tag dir exists, the metadata parses, and every
    manifest leaf file exists with its recorded byte size; with
    ``verify_integrity`` also each leaf's CRC32 (a full read)."""
    ckpt_dir = os.path.join(load_dir, tag)
    if not os.path.isdir(ckpt_dir):
        return [f"tag dir {ckpt_dir} does not exist"]
    try:
        meta = read_metadata(ckpt_dir)
    except CheckpointError as exc:
        return [str(exc)]
    problems = []
    manifest = meta.get("manifest", [])
    if not isinstance(manifest, list):
        return [f"metadata manifest is {type(manifest).__name__}, not a list"]
    for i, entry in enumerate(manifest):
        key = entry.get("key") if isinstance(entry, dict) else None
        if not isinstance(key, str):
            # still-valid JSON damage reads as "tag invalid", not a KeyError
            # out of the fallback walk this check protects
            problems.append(f"manifest entry {i} is malformed (no 'key')")
            continue
        path = os.path.join(ckpt_dir, key + ".npy")
        if not os.path.exists(path):
            problems.append(f"leaf {key}: file missing")
            continue
        want_bytes = entry.get("nbytes")
        if want_bytes is not None and os.path.getsize(path) != want_bytes:
            problems.append(f"leaf {key}: size {os.path.getsize(path)} != manifest {want_bytes}")
            continue
        if verify_integrity and entry.get("crc32") is not None:
            got = file_crc32(path)
            if got != entry["crc32"]:
                problems.append(f"leaf {key}: crc32 {got:#010x} != manifest {entry['crc32']:#010x}")
    return problems


def validate_checkpoint_tag(load_dir: str, tag: str, verify_integrity: bool = False) -> None:
    problems = check_checkpoint_tag(load_dir, tag, verify_integrity=verify_integrity)
    if problems:
        raise CheckpointError(
            f"checkpoint {load_dir!r} tag {tag!r} failed validation: " + "; ".join(problems)
            + " — pass another tag or load_checkpoint(..., fallback_to_valid=True)")


def is_valid_tag(load_dir: str, tag: str, verify_integrity: bool = False) -> bool:
    return not check_checkpoint_tag(load_dir, tag, verify_integrity=verify_integrity)


def find_latest_valid_tag(load_dir: str, verify_integrity: bool = False,
                          exclude: Tuple[str, ...] = ()) -> Optional[str]:
    """The newest tag (index, then mtime order) that passes validation."""
    for tag in reversed(list_tags(load_dir)):
        if tag in exclude:
            continue
        if is_valid_tag(load_dir, tag, verify_integrity=verify_integrity):
            return tag
    return None


# -------------------------------------------------------------------- retention
def sweep_retention(save_dir: str, keep_last_n: Optional[int],
                    verify_integrity: bool = False) -> List[str]:
    """Delete tags older than the newest ``keep_last_n``.  Never deletes the
    tag ``latest`` names, and never the only VALID checkpoint: when
    everything inside the window is corrupt, the newest valid tag outside it
    is kept, so that a fallback load always has somewhere to land."""
    if not keep_last_n or keep_last_n < 1:
        return []
    tags = list_tags(save_dir)
    if len(tags) <= keep_last_n:
        return []
    keep = set(tags[-keep_last_n:])
    try:
        latest = get_latest_tag(save_dir)
    except CheckpointError:
        latest = None
    if latest is not None:
        keep.add(latest)
    if not any(is_valid_tag(save_dir, t, verify_integrity) for t in keep):
        newest_valid = find_latest_valid_tag(save_dir, verify_integrity)
        if newest_valid is not None:
            keep.add(newest_valid)
    deleted = []
    for tag in tags:
        if tag in keep:
            continue
        shutil.rmtree(os.path.join(save_dir, tag), ignore_errors=True)
        deleted.append(tag)
    if deleted:
        _write_index(save_dir, [t for t in tags if t not in set(deleted)])
        logger.info(f"checkpoint retention: deleted {deleted} (keep_last_n={keep_last_n})")
    return deleted


# ------------------------------------------------------------------------- save
def save_checkpoint_dir(save_dir: str, tag: str, state, client_state: Dict,
                        engine: Optional[CheckpointEngine] = None):
    """Write the full state under ``save_dir/tag/`` and update ``latest``.

    Crash-safe order: stage under ``.tmp_<tag>/`` -> fsync the leaves ->
    write the manifest (CRC32 and size of each leaf as it landed) -> fsync
    the staging dir -> rename to ``<tag>/`` -> ``engine.commit(tag)`` -> flip
    ``latest``."""
    engine = engine or NativeCheckpointEngine()
    final_dir = os.path.join(save_dir, tag)
    tmp_dir = os.path.join(save_dir, TMP_PREFIX + tag)
    _ACTIVE_STAGING.add(tmp_dir)
    try:
        _sweep_stale_tmp(save_dir)
        if os.path.isdir(tmp_dir):  # an earlier attempt of THIS save (retry)
            shutil.rmtree(tmp_dir)
        engine.makedirs(tmp_dir)
        manifest = []
        for key, leaf in flatten_with_keys(state):
            arr = to_host(leaf)
            engine.save(arr, os.path.join(tmp_dir, key + ".npy"))
            manifest.append({"key": key, "shape": list(arr.shape), "dtype": str(arr.dtype)})
        # every leaf's bytes are durable BEFORE the manifest describes them and
        # the rename publishes them (the async engine drains its queue here)
        engine.flush()
        for entry in manifest:
            leaf_path = os.path.join(tmp_dir, entry["key"] + ".npy")
            fsync_file(leaf_path)
            entry["nbytes"] = os.path.getsize(leaf_path)
            # the CRC of the file as it landed on disk: a torn or bitflipped
            # write is caught now, not at the next resume
            entry["crc32"] = file_crc32(leaf_path)
        meta = {"format_version": FORMAT_VERSION, "tag": tag, "manifest": manifest,
                "client_state": _jsonable(client_state)}
        atomic_write_text(os.path.join(tmp_dir, METADATA_FILE), json.dumps(meta, indent=1))
        fsync_dir(tmp_dir)
        replaced = None
        if os.path.isdir(final_dir):
            # re-saving an existing tag: park the old copy under a VALID tag
            # name, so that a crash between the two renames still leaves a
            # complete checkpoint for the fallback walk; removed only after
            # `latest` flips
            replaced = final_dir + ".prev"
            if os.path.isdir(replaced):
                shutil.rmtree(replaced)
            os.rename(final_dir, replaced)
        os.rename(tmp_dir, final_dir)
        fsync_dir(save_dir)
        # commit AFTER the rename: the tag a plug-in engine marks durable
        # names a complete, manifest-bearing directory
        engine.commit(tag)
        _append_index(save_dir, tag)
        atomic_write_text(os.path.join(save_dir, LATEST_FILE), tag)
        if replaced is not None:
            shutil.rmtree(replaced, ignore_errors=True)
        logger.info(f"saved checkpoint {tag} -> {final_dir} ({len(manifest)} leaves)")
    finally:
        _ACTIVE_STAGING.discard(tmp_dir)


def save_checkpoint_with_retries(save_dir: str, tag: str, state, client_state: Dict,
                                 engine: Optional[CheckpointEngine] = None, retries: int = 0,
                                 backoff_secs: float = 0.5, on_retry=None):
    """``save_checkpoint_dir`` with bounded exponential-backoff retries over
    a transient ``OSError``.  Any other failure propagates at once."""
    attempts = max(int(retries), 0) + 1
    for attempt in range(attempts):
        try:
            return save_checkpoint_dir(save_dir, tag, state, client_state, engine=engine)
        except OSError as exc:
            if attempt + 1 >= attempts:
                raise
            delay = backoff_secs * (2**attempt)
            logger.warning(f"checkpoint save {tag} attempt {attempt + 1}/{attempts} "
                           f"failed ({exc!r}); retrying in {delay:.2f}s")
            if on_retry is not None:
                on_retry(attempt + 1, exc)
            if delay > 0:
                time.sleep(delay)


def on_rank0(save):
    """Run ``save()`` on rank 0 alone while every other rank waits for its
    outcome, broadcast from rank 0 under the bounded wait of
    ``comm.bounded_collective`` (``fault_tolerance.collective_timeout_s``); at a
    world size of 1 just ``save()``.  A failed save raises on every rank: rank
    0 raises its own error, the others a :class:`CheckpointError` naming it,
    so no rank goes on as if the checkpoint existed.  Returns what ``save``
    returned (None on the other ranks)."""
    import torch.distributed as dist

    from ..comm import comm
    if comm.get_world_size() == 1:
        return save()
    result, failure = None, None
    if comm.get_rank() == 0:
        try:
            result = save()
        except Exception as exc:  # raised after every rank has heard of it
            failure = exc
    outcome = [None if failure is None else f"{type(failure).__name__}: {failure}"]
    comm.bounded_collective(dist.broadcast_object_list, outcome, src=0,
                            name="checkpoint_save")
    if failure is not None:
        raise failure
    if outcome[0] is not None:
        raise CheckpointError(f"rank 0 failed to save the checkpoint ({outcome[0]}); "
                              f"rank {comm.get_rank()} saved nothing either")
    return result


def _jsonable(obj):
    """A JSON-safe deep copy of client_state: numpy arrays and tensors become
    lists (or Python scalars when 0-d), numpy scalars Python scalars."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    logger.warning(f"client_state value of type {type(obj).__name__} is not "
                   f"JSON-serializable; storing str() representation")
    return str(obj)


# ------------------------------------------------------------------------- load
def _restore_leaf(arr: np.ndarray, cur, key: str, device):
    """``arr`` from a checkpoint in the place of the template leaf ``cur``:
    same shape, ``cur``'s type and dtype, tensors on ``device``."""
    expected = tuple(cur.shape) if isinstance(cur, (torch.Tensor, np.ndarray)) else ()
    if tuple(arr.shape) != expected:
        raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != model shape {expected}")
    if isinstance(cur, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=cur.dtype)
    if isinstance(cur, (int, np.integer)):
        return int(arr)
    if isinstance(cur, (float, np.floating)):
        return float(arr)
    return np.asarray(arr).astype(np.asarray(cur).dtype)


def load_checkpoint_dir(load_dir: str, tag: Optional[str], state_template, device,
                        load_optimizer_states: bool = True, verify_integrity: bool = False,
                        validate: bool = True) -> Tuple[Any, Dict]:
    """Rebuild a train state from disk on ``device``.  ``state_template``
    gives the structure, types and dtypes; each of its leaves is looked up by
    key, and a key the checkpoint lacks keeps the template's value, with a
    warning (a JAX checkpoint has no ``torch_rng``; the port's template has
    no ``rng``, which is ignored).  ``load_optimizer_states=False`` keeps the
    template's ``opt_state`` and ``loss_scale``.

    The tag is validated first (manifest completeness and sizes, CRC32s too
    with ``verify_integrity``); a bad tag raises :class:`CheckpointError`
    before any leaf is read.  Callers that validated already pass
    ``validate=False``."""
    tag = tag or get_latest_tag(load_dir)
    if tag is None:
        raise CheckpointError(
            f"checkpoint dir {load_dir!r} has no '{LATEST_FILE}' file and no tag was "
            f"given — nothing to resume from; pass an explicit tag or save first")
    if validate:
        validate_checkpoint_tag(load_dir, tag, verify_integrity=verify_integrity)
    ckpt_dir = os.path.join(load_dir, tag)
    meta = read_metadata(ckpt_dir)
    available = {m["key"] for m in meta["manifest"]}

    def leaf(key, cur):
        skip = (not load_optimizer_states) and key.split(".")[0] in ("opt_state", "loss_scale")
        if skip:
            return cur
        if key not in available:
            logger.warning(f"checkpoint missing leaf {key}; keeping current value")
            return cur
        return _restore_leaf(np.load(os.path.join(ckpt_dir, key + ".npy")), cur, key, device)

    state = map_with_keys(leaf, state_template)
    logger.info(f"loaded checkpoint {tag} from {ckpt_dir}")
    return state, meta.get("client_state", {})
