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

Not ported: the chaos hooks (``ROADMAP.md`` A11) and sharded checkpoints
(A8/A13: a sharded JAX file is refused by name).
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

from .resilience.async_writer import AsyncCheckpointWriter, CheckpointWriteError

logger = logging.getLogger(__name__)


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint file is torn: its bytes do not match the checksum its
    ``.sum`` sidecar recorded at write time (or the file cannot be read
    at all after retries).  Restore paths catch this and fall back to
    the previous intact checkpoint."""


class ShardedCheckpointError(NotImplementedError):
    """A sharded JAX checkpoint (its leaves in ``.shard<p>`` files): the
    port restores none (ROADMAP.md A8/A13)."""


class CheckpointFormatError(ValueError):
    """An intact file this package cannot read: torch's zip format, or a
    pickle that refers to the JAX package's own classes."""


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
    for attempt in range(retries):
        try:
            with open(filename + ".tmp", "wb") as f:
                w = _HashingWriter(f)
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
                marker = json.loads(f.read().decode())
            if (len(payload) == marker.get("size")
                    and _digest(payload) == marker.get("digest")):
                return payload
            last = CheckpointIntegrityError(
                f"{filename} is torn: {len(payload)} bytes, sha256 "
                f"{_digest(payload)[:12]}… does not match its .sum marker "
                f"({marker.get('size')} bytes, "
                f"{str(marker.get('digest'))[:12]}…). If you edited the "
                f"checkpoint intentionally, delete the stale "
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
    markers, which the port refuses.  bf16 arrays need ``ml_dtypes``."""

    def find_class(self, module, name):
        if _JAX_PACKAGE.fullmatch(module):
            if name == "ShardedLeaf":
                raise ShardedCheckpointError(
                    "sharded checkpoint (its leaves live in .shard<p> "
                    "files): sharded restore is not ported to the PyTorch "
                    "trainer yet (ROADMAP.md A8/A13)")
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
    if arg_overrides and state.get("args") is not None:
        for name, value in arg_overrides.items():
            setattr(state["args"], name, value)
    return state


def verify_checkpoint_directory(save_dir):
    """Fail fast if the checkpoint directory is not writable."""
    os.makedirs(save_dir, exist_ok=True)
    probe = os.path.join(save_dir, ".write-probe")
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
            for path in (stale, _sum_path(stale)):
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

    def __init__(self, args, is_master=True):
        self.args = args
        self.is_master = is_master
        self.best = BestTracker(args.maximize_best_checkpoint_metric)
        self.async_save = str(getattr(args, "async_save", "on")) != "off"
        self._writer = None
        # step-path time spent on saves (capture + submit backpressure,
        # or the whole write when synchronous)
        self.stall_s = 0.0
        self.saves = 0
        self._publisher = None
        if is_master and not args.no_save:
            verify_checkpoint_directory(args.save_dir)
            verify_checkpoint_directory(args.tmp_save_dir)
            if self.async_save:
                self._writer = AsyncCheckpointWriter(
                    max_queue=int(getattr(args, "save_queue_size", 2) or 2))
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
        if self.args.no_save or not do_save or not self.is_master:
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
        scratch = os.path.join(self.args.tmp_save_dir, names[0])
        finals = [os.path.join(self.args.save_dir, n) for n in names]
        job = functools.partial(self._write_and_finalize, state_dict,
                                scratch, finals, end_of_epoch, updates)
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
                            publish_step=0):
        """Writer-thread body: serialize, copy to the final names, prune,
        then publish.  Raises on a write or copy failure, which
        :meth:`poll` re-raises."""
        atomic_save(state_dict, scratch)
        self._finalize(scratch, finals, end_of_epoch)
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

    def _finalize(self, scratch, finals, end_of_epoch):
        """Copy the scratch write to its final names, then prune."""
        copied_any = False
        failed = []
        for dst in finals:
            if dst == scratch:
                continue
            try:
                # data first, .sum last: a crash mid-copy leaves a
                # destination that verified reads reject
                shutil.copyfile(scratch, dst)
                shutil.copyfile(_sum_path(scratch), _sum_path(dst))
                copied_any = True
                logger.info("copied %s -> %s", scratch, dst)
            except Exception as e:
                logger.error("checkpoint copy to %s failed", dst,
                             exc_info=True)
                failed.append((dst, e))
        try:
            if (copied_any and not failed
                    and self.args.tmp_save_dir != self.args.save_dir):
                for q in (scratch, _sum_path(scratch)):
                    if os.path.lexists(q):
                        os.remove(q)
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
