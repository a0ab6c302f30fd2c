"""Checkpoint lifecycle of the port: naming, writing, retention, restore
(copy-and-adapt of ``unicore_tpu/checkpoint_utils.py``).

The file format is the JAX package's, so either package reads the
other's files: a pickled tree of numpy arrays and plain Python values
(``pickle`` protocol 4), never torch's zip format, written by
:func:`atomic_save` through tmp+rename with a ``<file>.sum`` sidecar
(sha256 and size of the exact bytes) renamed into place last.  Files
keep the ``.pt`` suffix and the reference's names:
``checkpoint{epoch}.pt``, ``checkpoint_{epoch}_{updates}.pt``,
``checkpoint_best.pt``, ``checkpoint.best_{metric}_{value}.pt`` and
``checkpoint_last.pt``, pruned by ``--keep-interval-updates``,
``--keep-last-epochs`` and ``--keep-best-checkpoints``.

:class:`CheckpointManager` owns the best-metric tracker, the background
writer (``--async-save``, the default) and the save and restore
decisions.  A restore whose file is torn falls back to the previous
intact checkpoint in the save dir.

With ``--publish-dir`` every save that fully lands also lands a
verified weight manifest there (:class:`~unicore_tpu_torch.deploy.
publish.WeightPublisher`, the JAX package's manifest format), for a
serving fleet's canary rollout; a failed publish is logged and never
fails the save.

Under data parallelism rank 0 writes the main file and each rank with
sharded state (``--zero1``'s optimizer slices; ``--comms-overlap``'s
params and EMA too) writes ``<file>.shard<rank>`` beside it, each with
its sidecar: the JAX package's layout, in which the main file holds a
``unicore_tpu.checkpoint_utils.ShardedLeaf`` marker for each sharded leaf
(pickled under that name, :class:`ShardedLeaf`, without importing the JAX
package) and a ``shard_token`` that rejects stale shard files of another
save.  A shard file holds ``{"process_index", "token", "entries"}``,
``entries`` mapping a leaf's path to its pieces keyed by their index
(``((start, stop), ...)`` per dimension).  A restore reads its own file's
pieces and, where the piece it needs is not there (another world size),
every shard file of the save (:class:`ShardReader`).

The chaos tool's crash windows (``UNICORE_TPU_CHAOS_WRITE_FAIL``,
``UNICORE_TPU_CHAOS_WRITE_HOLD``) are the JAX package's.  Not ported: a
file of the layouts only A13 writes (fsdp, tensor or sequence
parallelism) is refused by name.
"""

import ast
import functools
import glob
import hashlib
import io
import json
import logging
import os
import pickle
import re
import shutil
import time
import traceback

import numpy as np

from .resilience.async_writer import AsyncCheckpointWriter, CheckpointWriteError

logger = logging.getLogger(__name__)


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint file is torn: its bytes do not match the checksum its
    ``.sum`` sidecar recorded at write time (or the file cannot be read
    at all after retries).  Restore paths catch this and fall back to
    the previous intact checkpoint."""


class ShardedCheckpointError(NotImplementedError):
    """A sharded JAX checkpoint of a layout only ``ROADMAP.md`` A13 writes
    (fsdp, tensor or sequence parallelism)."""


class ShardedLeaf:
    """A leaf whose data lives in the ``.shard<p>`` files: its shape and
    dtype name.  Pickled as the JAX package's
    ``unicore_tpu.checkpoint_utils.ShardedLeaf`` (same slots), and read
    back from that name, so the markers of either package's files are
    the same bytes."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = str(dtype)

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return f"ShardedLeaf(shape={self.shape}, dtype={self.dtype})"


JAX_SHARDED_LEAF = ("unicore_tpu.checkpoint_utils", "ShardedLeaf")


class _JaxNamePickler(pickle._Pickler):
    """Pickler that writes :class:`ShardedLeaf` under the JAX package's
    module and name (the STACK_GLOBAL opcode, with no import of that
    module to check it, as the standard pickler would)."""

    def save_global(self, obj, name=None):
        if obj is ShardedLeaf:
            self.save(JAX_SHARDED_LEAF[0])
            self.save(JAX_SHARDED_LEAF[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def has_markers(tree):
    if isinstance(tree, ShardedLeaf):
        return True
    if isinstance(tree, dict):
        return any(has_markers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_markers(v) for v in tree)
    return False


class CheckpointFormatError(ValueError):
    """An intact file this package cannot read: torch's zip format, or a
    pickle that refers to the JAX package's own classes."""


# ----------------------------------------------------------------------
# the chaos tool's crash windows (``unicore_tpu_torch/tools/chaos.py``,
# the JAX package's variables): inert without their environment
# variable, and each fires at most once a process, so a resumed run is
# unaffected
# ----------------------------------------------------------------------

_CHAOS = {"writes": 0, "holds": 0, "held": False}


def _chaos_take_write_fail():
    """``UNICORE_TPU_CHAOS_WRITE_FAIL=K``: the K-th ``atomic_save`` of this
    process fails (every retry) with an injected OSError."""
    spec = os.environ.get("UNICORE_TPU_CHAOS_WRITE_FAIL")
    if not spec:
        return False
    _CHAOS["writes"] += 1
    return _CHAOS["writes"] == int(spec)


def _chaos_finalize_hold(dst):
    """``UNICORE_TPU_CHAOS_WRITE_HOLD=<substr>:<sentinel>:<secs>``: while
    finalizing a destination whose name contains ``<substr>``, touch
    ``<sentinel>`` and sleep between the data copy and the ``.sum`` copy
    (the kill-between-data-and-marker window), at the
    ``UNICORE_TPU_CHAOS_WRITE_HOLD_AT``-th such finalize (default 1)."""
    spec = os.environ.get("UNICORE_TPU_CHAOS_WRITE_HOLD")
    if not spec or _CHAOS["held"]:
        return
    substr, _, rest = spec.partition(":")
    sentinel, _, secs = rest.rpartition(":")
    if substr not in os.path.basename(dst):
        return
    _CHAOS["holds"] += 1
    if _CHAOS["holds"] != int(
            os.environ.get("UNICORE_TPU_CHAOS_WRITE_HOLD_AT", "1")):
        return
    _CHAOS["held"] = True
    with open(sentinel, "w") as f:
        f.write(dst)
    logger.warning("CHAOS: holding %ss inside the data->marker copy window "
                   "of %s", secs, dst)
    time.sleep(float(secs))


# ----------------------------------------------------------------------
# low-level IO
# ----------------------------------------------------------------------

def _sum_path(filename):
    return filename + ".sum"


def _digest(payload):
    return hashlib.sha256(payload).hexdigest()


class _HashingWriter:
    """File wrapper that hashes and counts the bytes as pickle streams
    through it: the ``.sum`` marker comes out of the write itself, with
    no second copy of the checkpoint in host memory."""

    def __init__(self, fh):
        self._fh = fh
        self.hasher = hashlib.sha256()
        self.size = 0

    def write(self, data):
        self.hasher.update(data)
        self.size += len(data)
        return self._fh.write(data)


def atomic_save(obj, filename, retries=3, backoff=0.5):
    """Pickle ``obj`` to ``filename`` via tmp+rename, retried with
    exponential backoff on errors; raises after the last retry.

    Every write leaves a ``<filename>.sum`` sidecar (sha256 and size of
    the exact bytes), the final marker of the save: the data file renames
    into place first, the sidecar second, so a crash between the two
    leaves a data file whose sidecar mismatches (or is missing), which
    verified reads treat as torn."""
    inject_fail = _chaos_take_write_fail()
    for attempt in range(retries):
        try:
            if inject_fail:
                raise OSError("chaos: injected checkpoint writer IO failure "
                              "(UNICORE_TPU_CHAOS_WRITE_FAIL)")
            with open(filename + ".tmp", "wb") as f:
                w = _HashingWriter(f)
                if has_markers(obj):
                    _JaxNamePickler(w, protocol=4).dump(obj)
                else:
                    pickle.dump(obj, w, protocol=4)
            marker = json.dumps({
                "algo": "sha256", "digest": w.hasher.hexdigest(),
                "size": w.size,
            }).encode()
            with open(_sum_path(filename) + ".tmp", "wb") as f:
                f.write(marker)
            os.replace(filename + ".tmp", filename)
            os.replace(_sum_path(filename) + ".tmp", _sum_path(filename))
            return
        except Exception:
            if attempt == retries - 1:
                logger.error(traceback.format_exc())
                raise
            time.sleep(backoff * (2 ** attempt))


def read_sidecar(filename):
    """The ``.sum`` marker of ``filename`` (``{"algo", "digest",
    "size"}``); raises :class:`CheckpointIntegrityError` when it is
    absent or unparseable."""
    try:
        with open(_sum_path(filename), "rb") as f:
            marker = json.loads(f.read().decode())
    except FileNotFoundError as e:
        raise CheckpointIntegrityError(
            f"{filename} has no .sum sidecar to read") from e
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(
            f"unreadable .sum sidecar for {filename}: {e}") from e
    if "digest" not in marker:
        raise CheckpointIntegrityError(
            f"malformed .sum sidecar for {filename}: {marker!r}")
    return marker


def _sidecar_required(filename):
    """Is a missing ``.sum`` sidecar proof of a torn save for this file?

    A checkpoint written before sidecars existed has none, and loads
    unverified.  But when a sibling of the same save round (the main
    file, or a ``.shardN`` of a sharded JAX save) carries one, the round
    was written by integrity-aware code and this file's marker never
    landed: treat it as torn."""
    main = re.sub(r"\.shard\d+$", "", filename)
    if filename != main and os.path.exists(_sum_path(main)):
        return True
    return any(re.fullmatch(r".*\.shard\d+\.sum", fn)
               for fn in glob.glob(main + ".shard*"))


def read_verified(filename, retries=3, backoff=0.5):
    """Read ``filename`` and verify it against its ``.sum`` sidecar.

    Transient failures (an OSError mid-read, a mismatch while a copy is
    still landing) retry with exponential backoff; a persistent mismatch
    raises :class:`CheckpointIntegrityError`.  A file without a sidecar
    is accepted with a warning only when its whole save round has none
    (:func:`_sidecar_required`)."""
    last = None
    for attempt in range(retries):
        try:
            with open(filename, "rb") as f:
                payload = f.read()
            if not os.path.exists(_sum_path(filename)):
                if _sidecar_required(filename):
                    raise CheckpointIntegrityError(
                        f"{filename} has no .sum sidecar but its save round "
                        "does: the save was interrupted before the final "
                        "marker landed; treating as torn")
                logger.warning("%s has no .sum sidecar (pre-integrity "
                               "checkpoint); loading UNVERIFIED", filename)
                return payload
            with open(_sum_path(filename), "rb") as f:
                raw = f.read()
            try:
                marker = json.loads(raw.decode())
            except ValueError:
                # a kill while the marker was copied leaves it empty or
                # cut: the file is torn and the restore falls back
                marker = None
            if marker is None:
                last = CheckpointIntegrityError(
                    f"{filename} is torn: its .sum marker "
                    f"({len(raw)} bytes) is unreadable")
            elif (len(payload) == marker.get("size")
                    and _digest(payload) == marker.get("digest")):
                return payload
            else:
                last = CheckpointIntegrityError(
                    f"{filename} is torn: {len(payload)} bytes, sha256 "
                    f"{_digest(payload)[:12]}… does not match its .sum "
                    f"marker ({marker.get('size')} bytes, "
                    f"{str(marker.get('digest'))[:12]}…). If you edited "
                    f"the checkpoint intentionally, delete the stale "
                    f"{_sum_path(filename)}")
        except FileNotFoundError:
            raise  # not transient: nothing to back off for
        except OSError as e:
            last = e
        logger.warning("checkpoint read %s failed (attempt %d/%d): %s",
                       filename, attempt + 1, retries, last)
        if attempt < retries - 1:
            time.sleep(backoff * (2 ** attempt))
    if isinstance(last, CheckpointIntegrityError):
        raise last
    raise CheckpointIntegrityError(
        f"could not read {filename} after {retries} attempts: {last}"
    ) from last


def file_integrity(path):
    """Classify one checkpoint file: ``ok`` (its bytes match the .sum
    marker), ``unverified`` (no marker anywhere in its round) or ``torn``
    (unreadable, marker unreadable or mismatched, or marker missing while
    a sibling of its round has one)."""
    try:
        with open(path, "rb") as f:
            payload = f.read()
    except OSError:
        return "torn"
    sum_file = _sum_path(path)
    if not os.path.exists(sum_file):
        return "torn" if _sidecar_required(path) else "unverified"
    try:
        with open(sum_file, "rb") as f:
            marker = json.loads(f.read().decode())
    except (OSError, ValueError):
        return "torn"
    ok = (len(payload) == marker.get("size")
          and _digest(payload) == marker.get("digest"))
    return "ok" if ok else "torn"


_JAX_PACKAGE = re.compile(r"unicore_tpu(_cli)?(\..*)?")


class _Unpickler(pickle.Unpickler):
    """Unpickler that never imports the JAX package.  A JAX-written file
    holds numpy arrays, plain values and an ``argparse.Namespace``; a
    sharded one also holds ``unicore_tpu.checkpoint_utils.ShardedLeaf``
    markers, read as :class:`ShardedLeaf`.  bf16 arrays need
    ``ml_dtypes``."""

    def find_class(self, module, name):
        if (module, name) == JAX_SHARDED_LEAF:
            return ShardedLeaf
        if _JAX_PACKAGE.fullmatch(module):
            raise CheckpointFormatError(
                f"the checkpoint refers to {module}.{name} of the JAX "
                "package, which the port does not import")
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError as e:
            if module.split(".")[0] == "ml_dtypes":
                raise ModuleNotFoundError(
                    "the checkpoint holds bf16 arrays (JAX --optim-bf16-"
                    "moments); reading them needs the ml_dtypes package, "
                    "which this host does not have") from e
            raise


def load_checkpoint_to_cpu(path, arg_overrides=None):
    """Read a checkpoint into host memory (numpy tree + metadata).  The
    read is verified against the ``.sum`` marker; a torn file raises
    :class:`CheckpointIntegrityError` for the caller's fallback."""
    payload = read_verified(path)
    if payload[:2] == b"PK":
        raise CheckpointFormatError(
            f"{path} is a torch-format (zip) checkpoint; this format is "
            "a pickled tree of numpy arrays. Convert reference Uni-Core "
            "weights first with the JAX package's "
            "unicore_tpu.tools.convert_torch_checkpoint")
    try:
        state = _Unpickler(io.BytesIO(payload)).load()
    except (NotImplementedError, ModuleNotFoundError, CheckpointFormatError):
        raise
    except Exception as e:
        # bytes that passed the digest check (or carried no sidecar) but
        # do not unpickle are still a torn checkpoint to the caller
        raise CheckpointIntegrityError(f"{path} does not unpickle: {e}") from e
    _refuse_a13_layout(state, path)
    if arg_overrides and state.get("args") is not None:
        for name, value in arg_overrides.items():
            setattr(state["args"], name, value)
    return state


def _refuse_a13_layout(state, path):
    """Raise for a sharded file of a layout that only ROADMAP.md A13's
    parallelism writes: one saved under fsdp, tensor or sequence
    parallelism, or whose params are sharded without
    ``--comms-overlap``."""
    model = state.get("model") if isinstance(state, dict) else None
    if not isinstance(model, dict) or not has_markers(model):
        return
    args = state.get("args")
    a13 = [flag for flag, attr, off in (
        ("--fsdp-size", "fsdp_size", 1), ("--fsdp", "fsdp", False),
        ("--tensor-parallel-size", "tensor_parallel_size", 1),
        ("--seq-parallel-size", "seq_parallel_size", 1))
        if getattr(args, attr, off) not in (off, None)]
    if not a13 and not getattr(args, "comms_overlap", False) and any(
            has_markers(model.get(k)) for k in ("params", "ema")):
        a13 = ["sharded params without --comms-overlap"]
    if a13:
        raise ShardedCheckpointError(
            f"{path} is sharded in a layout the PyTorch trainer does not "
            f"restore yet ({', '.join(a13)}; ROADMAP.md A13)")


def shard_file(path, rank):
    return f"{path}.shard{rank}"


def write_checkpoint(state_dict, shard_entries, filename, is_master, rank):
    """Write rank ``rank``'s part of a save: its shard file when it holds
    pieces of sharded leaves (``{"process_index", "token", "entries"}``,
    the JAX package's), and the main file on rank 0."""
    if shard_entries:
        atomic_save({"process_index": rank,
                     "token": state_dict.get("shard_token"),
                     "entries": shard_entries}, shard_file(filename, rank))
    if is_master:
        atomic_save(state_dict, filename)


def load_shard_entries(path, rank=None, token=None):
    """The pieces of ``path``'s shard files: rank ``rank``'s file, or
    every ``.shard<N>`` file when ``rank`` is None.  A file whose token is
    not ``token`` (a stale file of another save) is skipped with a
    warning; each read is verified against its sidecar.  Returns
    ``{leaf path: [(index, array), ...]}`` merged across the files."""
    if rank is not None:
        files = [shard_file(path, rank)]
        if not os.path.exists(files[0]):
            return {}
    else:
        files = [fn for fn in sorted(glob.glob(path + ".shard*"))
                 if re.fullmatch(r".*\.shard\d+", fn)]
    merged = {}
    for fn in files:
        payload = _Unpickler(io.BytesIO(read_verified(fn))).load()
        if token is not None and payload.get("token") != token:
            logger.warning("ignoring stale shard file %s (token %r != %r)",
                           fn, payload.get("token"), token)
            continue
        for key, entries in payload["entries"].items():
            merged.setdefault(key, []).extend(entries)
    return merged


class ShardReader:
    """The sharded leaves of one checkpoint: a piece by its index from
    this rank's own file first, then from every shard file of the save
    (read once, when a piece is not in the own file: another world
    size), or a whole leaf assembled from all pieces."""

    def __init__(self, path, token, rank=0):
        self.path, self.token = path, token
        self.own = load_shard_entries(path, rank, token)
        self._all = None

    @property
    def everything(self):
        if self._all is None:
            logger.warning("checkpoint: shard layout changed for %s; "
                           "reading every shard file", self.path)
            self._all = load_shard_entries(self.path, None, self.token)
        return self._all

    def piece(self, key, index):
        """The piece of leaf ``key`` at ``index``, or None."""
        for idx, arr in self.own.get(key, []):
            if tuple(map(tuple, idx)) == tuple(index):
                return np.asarray(arr)
        for idx, arr in self.everything.get(key, []):
            if tuple(map(tuple, idx)) == tuple(index):
                return np.asarray(arr)
        return None

    def full(self, key, marker):
        """Leaf ``key`` whole (fp32 numpy), from every piece of it; a gap
        or two pieces that disagree raise."""
        full = np.empty(marker.shape, np.float32)
        covered = np.zeros(marker.shape, bool)
        for idx, piece in self.everything.get(key, []):
            sl = tuple(slice(a, b) for a, b in idx)
            piece = np.asarray(piece, np.float32)
            overlap = covered[sl]
            if overlap.any() and not np.array_equal(
                    full[sl][overlap], piece[overlap], equal_nan=True):
                raise ValueError(
                    f"conflicting shard pieces for {key} at {idx}: mixed "
                    f"shard files of different saves next to {self.path}?")
            full[sl] = piece
            covered[sl] = True
        if not covered.all():
            raise ValueError(
                f"checkpoint shard files do not cover {key} "
                f"({int(covered.size - covered.sum())} of {covered.size} "
                f"elements missing); missing .shard files next to "
                f"{self.path}?")
        return full

    def assembled(self, tree, prefix):
        """``tree`` (a flax subtree at ``prefix``) with every marker
        replaced by its whole leaf."""
        if isinstance(tree, ShardedLeaf):
            return self.full(prefix, tree)
        if isinstance(tree, dict):
            return {k: self.assembled(v, f"{prefix}/{k}")
                    for k, v in tree.items()}
        return tree


def verify_checkpoint_directory(save_dir):
    """Fail fast if the checkpoint directory is not writable."""
    os.makedirs(save_dir, exist_ok=True)
    # one name a process: the ranks of a group probe the same directory
    probe = os.path.join(save_dir, f".write-probe.{os.getpid()}")
    try:
        with open(probe, "w"):
            pass
    except OSError:
        logger.warning("checkpoint directory is not writable: %s", save_dir)
        raise
    os.remove(probe)


def checkpoint_paths(path, pattern=r"checkpoint(\d+)\.pt"):
    """Checkpoints under ``path`` matching ``pattern``, newest first by the
    numeric capture group."""
    rx = re.compile(pattern)
    scored = []
    for name in os.listdir(path):
        m = rx.fullmatch(name)
        if m:
            score = float(m.group(1)) if m.groups() else 0.0
            scored.append((score, name))
    return [os.path.join(path, name)
            for _, name in sorted(scored, reverse=True)]


# ----------------------------------------------------------------------
# retention
# ----------------------------------------------------------------------

def _prune(args, end_of_epoch):
    """Delete checkpoints beyond the configured retention windows."""
    keep = []
    if not end_of_epoch and args.keep_interval_updates > 0:
        keep.append((r"checkpoint_\d+_(\d+)\.pt", args.keep_interval_updates,
                     False))
    if args.keep_last_epochs > 0:
        keep.append((r"checkpoint(\d+)\.pt", args.keep_last_epochs, False))
    if args.keep_best_checkpoints > 0:
        # the value group admits negatives and scientific notation
        keep.append((
            r"checkpoint\.best_{}_(-?\d+\.?\d*(?:[eE][+-]?\d+)?)\.pt".format(
                args.best_checkpoint_metric),
            args.keep_best_checkpoints,
            not args.maximize_best_checkpoint_metric,
        ))
    for pattern, limit, reverse in keep:
        survivors = checkpoint_paths(args.save_dir, pattern=pattern)
        if reverse:
            survivors = survivors[::-1]
        for stale in survivors[limit:]:
            # a sharded save's .shard<N> files (and sidecars) go with it
            for path in [stale, _sum_path(stale)] + glob.glob(
                    stale + ".shard*"):
                try:
                    os.remove(path)
                    logger.info("removed old checkpoint %s", path)
                except FileNotFoundError:
                    pass


# ----------------------------------------------------------------------
# manager
# ----------------------------------------------------------------------

class BestTracker:
    """Running best of the checkpoint metric (min or max)."""

    def __init__(self, maximize):
        self.maximize = maximize
        self.value = None

    def is_better(self, a, b):
        return a >= b if self.maximize else a <= b

    def update(self, val):
        """Fold ``val`` in; returns True if it is (tied-)best so far."""
        if val is None:
            return False
        if self.value is None or self.is_better(val, self.value):
            self.value = val
            return True
        return False


class CheckpointManager:
    """Owns checkpoint writing, retention, best tracking and restore.

    With ``--async-save`` (the default) the step path pays only the
    device->host capture; pickling, checksumming, the final-dir copies
    and retention run on the :class:`AsyncCheckpointWriter` while
    training continues.  A failed background write is raised on the main
    thread at the next step boundary (:meth:`poll`); ``--async-save off``
    writes synchronously (failures raise from :meth:`save`)."""

    def __init__(self, args, is_master=True, rank=0):
        self.args = args
        self.is_master = is_master
        self.rank = rank  # the .shard<rank> file this process writes
        self.best = BestTracker(args.maximize_best_checkpoint_metric)
        self.async_save = str(getattr(args, "async_save", "on")) != "off"
        self._writer = None
        # step-path time spent on saves (capture + submit backpressure,
        # or the whole write when synchronous)
        self.stall_s = 0.0
        self.saves = 0
        self._publisher = None
        if not args.no_save:
            # every rank may write its shard file
            verify_checkpoint_directory(args.save_dir)
            verify_checkpoint_directory(args.tmp_save_dir)
            if self.async_save:
                self._writer = AsyncCheckpointWriter(
                    max_queue=int(getattr(args, "save_queue_size", 2) or 2))
        if is_master and not args.no_save:
            self._sweep_stale_scratch()
            if getattr(args, "publish_dir", ""):
                # runtime import: deploy imports this module at its top
                from .deploy.publish import WeightPublisher

                self._publisher = WeightPublisher(args.publish_dir)

    @property
    def writer(self):
        """The background writer (None when synchronous or not saving)."""
        return self._writer

    def _sweep_stale_scratch(self):
        """Clear torn scratch files a crash mid-``_finalize`` left in the
        tmp dir.  Only torn files (missing or mismatched .sum) go: an
        intact scratch file may be a complete state the operator wants,
        so it is reported and left.  Nothing is touched when the tmp dir
        is the save dir."""
        a = self.args
        if os.path.realpath(a.tmp_save_dir) == os.path.realpath(a.save_dir):
            return
        for fn in sorted(glob.glob(os.path.join(a.tmp_save_dir,
                                                "checkpoint*.pt*"))):
            if fn.endswith(".tmp"):
                logger.warning("removing interrupted-save temp %s", fn)
                try:
                    os.remove(fn)
                except FileNotFoundError:
                    pass
                continue
            if fn.endswith(".sum"):
                continue
            state = file_integrity(fn)
            if state == "torn":
                logger.warning("removing torn scratch checkpoint left by an "
                               "interrupted save: %s", fn)
                for p in (fn, _sum_path(fn)):
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass
            else:
                logger.warning(
                    "%s scratch checkpoint %s was never copied to %s "
                    "(crash before finalize?); leaving it for manual "
                    "recovery", state, fn, a.save_dir)

    # -- save ----------------------------------------------------------

    def _target_names(self, epoch, updates, end_of_epoch, val_loss,
                      improved):
        """Which checkpoint filenames this round's state lands in."""
        a, suffix = self.args, getattr(self.args, "checkpoint_suffix", "") or ""
        names = []
        if (end_of_epoch and not a.no_epoch_checkpoints
                and epoch % a.save_interval == 0):
            names.append(f"checkpoint{epoch}{suffix}.pt")
        if (not end_of_epoch and a.save_interval_updates > 0
                and updates % a.save_interval_updates == 0):
            names.append(f"checkpoint_{epoch}_{updates}{suffix}.pt")
        if val_loss is not None and improved:
            names.append(f"checkpoint_best{suffix}.pt")
            if a.keep_best_checkpoints > 0:
                names.append(f"checkpoint.best_{a.best_checkpoint_metric}_"
                             f"{val_loss:.2f}.pt")
        if not a.no_last_checkpoints:
            names.append(f"checkpoint_last{suffix}.pt")
        return names

    def save(self, trainer, epoch_itr, val_loss, do_save=True):
        """Write this round's checkpoint under every applicable name.  The
        device->host capture happens here; with async save the pickling,
        IO, copies and retention run on the background writer, and a
        failed write surfaces at the next boundary (:meth:`poll`)."""
        improved = self.best.update(val_loss)
        if self.args.no_save or not do_save:
            return
        epoch = epoch_itr.epoch
        end_of_epoch = epoch_itr.end_of_epoch()
        updates = trainer.get_num_updates()
        names = self._target_names(epoch, updates, end_of_epoch, val_loss,
                                   improved)
        if not names:
            return
        extra_state = {"train_iterator": epoch_itr.state_dict(),
                       "val_loss": val_loss}
        if self.best.value is not None:
            extra_state["best"] = self.best.value
        t0 = time.perf_counter()
        state_dict = trainer.collect_checkpoint_state(extra_state)
        shards = trainer.shard_entries()
        if not self.is_master and not shards:
            return  # nothing this rank holds alone
        scratch = os.path.join(self.args.tmp_save_dir, names[0])
        finals = [os.path.join(self.args.save_dir, n) for n in names]
        job = functools.partial(self._write_and_finalize, state_dict,
                                scratch, finals, end_of_epoch, updates,
                                shards)
        if self._writer is not None:
            self._writer.submit(job, label=names[0])
            mode = "write is async"
        else:
            job()  # synchronous: write failures raise right here
            mode = "write was synchronous"
        stall = time.perf_counter() - t0
        self.stall_s += stall
        self.saves += 1
        logger.info("Saving checkpoint %s (epoch %d @ %d updates, score %s) "
                    "(step path stalled %.2f seconds; %s)", scratch, epoch,
                    updates, val_loss, stall, mode)

    def poll(self):
        """Raise a failed background write (CheckpointWriteError) on the
        caller's thread; the train loop calls it at every step boundary."""
        if self._writer is not None:
            self._writer.poll()

    def drain(self):
        """Block until every submitted save has landed, then raise if any
        of them failed: the end-of-run gate."""
        if self._writer is not None:
            self._writer.drain()
            self._writer.poll()

    def _write_and_finalize(self, state_dict, scratch, finals, end_of_epoch,
                            publish_step=0, shards=None):
        """Writer-thread body: serialize (the main file on rank 0, this
        rank's shard file where it holds sharded pieces), copy to the
        final names, prune, then publish.  Raises on a write or copy
        failure, which :meth:`poll` re-raises."""
        write_checkpoint(state_dict, shards, scratch, self.is_master,
                         self.rank)
        self._finalize(scratch, finals, end_of_epoch, bool(shards))
        if self._publisher is not None:
            # publish AFTER the save fully landed, and never fail the
            # save over it: a publish fault costs one rollout, a raised
            # one would cost the checkpoint
            try:
                m = self._publisher.publish(finals[0],
                                            source_step=publish_step)
                logger.info("published manifest %d -> %s (step %d)",
                            m.publish_id, finals[0], publish_step)
            except Exception:
                logger.error("weight publish of %s failed; training and "
                             "the checkpoint are unaffected", finals[0],
                             exc_info=True)

    def _finalize(self, scratch, finals, end_of_epoch, has_shards=False):
        """Copy the scratch write (the main file on rank 0, the shard
        file where there is one) to its final names, then prune."""
        copied_any = False
        failed = []
        pairs = []
        for dst in finals:
            if self.is_master:
                pairs.append((scratch, dst))
            if has_shards:
                pairs.append((shard_file(scratch, self.rank),
                              shard_file(dst, self.rank)))
        for src, dst in pairs:
            if dst == src:
                continue
            try:
                # data first, .sum last: a crash mid-copy leaves a
                # destination that verified reads reject
                shutil.copyfile(src, dst)
                _chaos_finalize_hold(dst)
                shutil.copyfile(_sum_path(src), _sum_path(dst))
                copied_any = True
                logger.info("copied %s -> %s", src, dst)
            except Exception as e:
                logger.error("checkpoint copy to %s failed", dst,
                             exc_info=True)
                failed.append((dst, e))
        try:
            if (copied_any and not failed
                    and self.args.tmp_save_dir != self.args.save_dir):
                # only this rank's own files: rank 0's main scratch file
                # may still be copying on a shared disk
                mine = ([scratch] if self.is_master else []) + (
                    [shard_file(scratch, self.rank)] if has_shards else [])
                for p in mine:
                    for q in (p, _sum_path(p)):
                        if os.path.lexists(q):
                            os.remove(q)
            if self.is_master:
                _prune(self.args, end_of_epoch)
        except Exception:
            logger.warning("checkpoint retention pass failed", exc_info=True)
        if failed:
            raise CheckpointWriteError(
                "checkpoint finalize failed for "
                + ", ".join(dst for dst, _ in failed)
                + f": {failed[0][1]} (scratch kept at {scratch})"
            ) from failed[0][1]

    def close(self):
        """Drain the background writer (every queued save lands before the
        process exits); safe inside ``finally`` blocks: failures are left
        for :meth:`drain`/:meth:`poll`."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    # -- restore -------------------------------------------------------

    def _resolve_restore(self):
        """(path, reset flags): ``--finetune-from-model`` applies only on
        the first launch with the default ``--restore-file``, and then
        resets the optimizer, scheduler, meters and dataloader."""
        a = self.args
        suffix = getattr(a, "checkpoint_suffix", "") or ""
        resets = {
            "optimizer": a.reset_optimizer,
            "lr_scheduler": a.reset_lr_scheduler,
            "meters": a.reset_meters,
            "dataloader": a.reset_dataloader,
        }
        if a.finetune_from_model is not None and any(resets.values()):
            raise ValueError(
                "--finetune-from-model cannot be combined with --reset-* "
                "flags (it implies all of them on first launch)")
        if a.restore_file != "checkpoint_last.pt":
            if a.finetune_from_model:
                raise ValueError(
                    "--finetune-from-model and a non-default --restore-file "
                    "cannot be used together")
            if suffix:
                return a.restore_file.replace(".pt", suffix + ".pt"), resets
            return a.restore_file, resets
        path = os.path.join(a.save_dir, f"checkpoint_last{suffix}.pt")
        if a.finetune_from_model is not None and not os.path.exists(path):
            if not os.path.exists(a.finetune_from_model):
                raise ValueError(f"--finetune-from-model "
                                 f"{a.finetune_from_model} does not exist")
            logger.info("first launch: finetuning from %s (optimizer, lr "
                        "scheduler, meters, dataloader start fresh)",
                        a.finetune_from_model)
            return a.finetune_from_model, {k: True for k in resets}
        return path, resets

    def _restore_candidates(self, path):
        """``path`` first, then (for a restore inside the save dir only)
        every other checkpoint there, newest first by mtime.  An explicit
        ``--restore-file`` or ``--finetune-from-model`` elsewhere fails
        loudly rather than train from a state the user never named."""
        yield path
        save_dir = os.path.realpath(self.args.save_dir)
        if os.path.realpath(os.path.dirname(path) or ".") != save_dir:
            return
        others = [fn for fn in glob.glob(os.path.join(self.args.save_dir,
                                                      "checkpoint*.pt"))
                  if os.path.realpath(fn) != os.path.realpath(path)]
        others.sort(key=os.path.getmtime, reverse=True)
        yield from others

    def restore(self, trainer, **itr_kwargs):
        """Load the restore checkpoint (if any) and build the train
        iterator; returns ``(extra_state, epoch_itr)``.  A torn checkpoint
        falls back to the previous intact one."""
        path, resets = self._resolve_restore()
        extra_state, last_err = None, None
        for candidate in self._restore_candidates(path):
            try:
                extra_state = trainer.load_checkpoint(
                    candidate, resets["optimizer"], resets["lr_scheduler"],
                    ast.literal_eval(self.args.optimizer_overrides),
                    reset_meters=resets["meters"],
                    load_from_ema=getattr(self.args, "load_from_ema", False))
                if candidate != path:
                    logger.warning(
                        "resumed from FALLBACK checkpoint %s (%s was torn); "
                        "updates since its save are re-run", candidate, path)
                break
            except CheckpointIntegrityError as e:
                logger.error("checkpoint %s is torn (%s); trying the "
                             "previous intact checkpoint", candidate, e)
                last_err = e
        else:
            raise CheckpointIntegrityError(
                f"no intact checkpoint found for {path}") from last_err
        if (extra_state is not None and "best" in extra_state
                and not resets["optimizer"] and not resets["meters"]):
            self.best.value = extra_state["best"]
        if extra_state is not None and not resets["dataloader"]:
            itr_state = extra_state["train_iterator"]
            epoch_itr = trainer.get_train_iterator(
                epoch=itr_state["epoch"], load_dataset=True, **itr_kwargs)
            epoch_itr.load_state_dict(itr_state)
        else:
            epoch_itr = trainer.get_train_iterator(
                epoch=1, load_dataset=True, **itr_kwargs)
        trainer.init_total_train_steps(epoch_itr)
        trainer.lr_step(epoch_itr.epoch)
        return extra_state, epoch_itr
