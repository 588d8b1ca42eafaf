"""Sharded checkpoints of the ZeRO storage modes, the port of
``adaptdl_tpu.sharded_checkpoint`` without orbax.

:class:`TrainerCheckpoint` gathers the rows to rank 0, which writes
them. Here every rank writes its own rows instead, and a restore at
another replica count reads, on each rank, only the canonical ranges its
new row holds:

- :meth:`ShardedTrainerCheckpoint.sync` (every rank, before the
  registry's save) writes the row of this rank's data coordinate (the
  seq ranks of a data row hold the same rows; the first of them writes)
  of each family -- the
  parameters, each optimizer moment and, under ``zero3_blocks``, the
  differenced carry -- as raw float32 bytes to ``rank-<r>.bin`` in a
  fresh versioned payload directory ``sharded/<name>-g<restart>.<seq>``
  that never replaces one a complete checkpoint references; beside it an
  index (``rank-<r>.json``: the row's canonical segments and each
  family's byte offset) and a sha256 sidecar
  (``<payload>.rank-<r>.sha256.json``, :func:`shard_hash_table`).
- The registry's payload, written by rank 0, is a JSON pointer: the
  payload directory, the replica count and mode that wrote it, and the
  small state (noise statistics, progress, step, seed, group ids).
- :meth:`ShardedTrainerCheckpoint.load` reads the pointer, then, for each
  family, the saved ranks' rows that overlap this rank's canonical
  segments at the current replica count, each checked against its
  sidecar first. Only raw tensor bytes and JSON are read: nothing is
  unpickled, from storage or from the handoff's peer (which serves the
  pointer).

The flat canonical order is the module's parameter order raveled, as in
the trainer's checkpoint, so a payload written under one ZeRO mode and
replica count restores under another with the same parameters. Dense
trainers keep :class:`TrainerCheckpoint`.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any, Callable

import numpy as np
import torch

from adaptdl_tpu_torch import checkpoint, collective, env, faults
from adaptdl_tpu_torch.parallel import mesh as pmesh

_CHUNK = 1 << 24  # bytes hashed or copied per read


def _sharded_root() -> str:
    root = env.checkpoint_path()
    if root is None:
        raise RuntimeError("ADAPTDL_CHECKPOINT_PATH is not set")
    return os.path.join(os.path.abspath(root), "sharded")


def _payload_pattern(name: str) -> re.Pattern:
    return re.compile(rf"^{re.escape(name)}-g(\d+)\.(\d+)$")


def _list_payload_dirs(name: str) -> list[tuple[int, int, str]]:
    """(restart, seq, path) of this state's payload dirs, ascending."""
    root = _sharded_root()
    found = []
    pattern = _payload_pattern(name)
    for entry in os.listdir(root) if os.path.isdir(root) else []:
        m = pattern.match(entry)
        if m and os.path.isdir(os.path.join(root, entry)):
            found.append((int(m[1]), int(m[2]), os.path.join(root, entry)))
    return sorted(found)


def _next_payload_dir(name: str) -> str:
    """A fresh payload dir for the save about to happen: one more than
    the highest sequence of this incarnation, so the payload the last
    complete checkpoint references is never written over."""
    restart = env.num_restarts()
    seq = max(
        (s for r, s, _ in _list_payload_dirs(name) if r == restart), default=-1
    ) + 1
    return os.path.join(_sharded_root(), f"{name}-g{restart}.{seq}")


def hash_table_path(payload_dir: str, rank: int) -> str:
    """Rank ``rank``'s sha256 sidecar of one payload dir (a sibling of
    the dir)."""
    return f"{payload_dir}.rank-{rank}.sha256.json"


def shard_hash_table(families: dict, rank: int) -> dict[str, dict]:
    """Content hashes of this rank's rows: ``{"<family>@<rank>":
    {"sha": ..., "bytes": n}}``."""
    table = {}
    for name, data in families.items():
        raw = memoryview(np.ascontiguousarray(data))
        table[f"{name}@{rank}"] = {
            "sha": hashlib.sha256(raw).hexdigest(),
            "bytes": int(raw.nbytes),
        }
    return table


def diff_shard_tables(prev: dict | None, cur: dict) -> tuple[list[str], int]:
    """Keys of ``cur`` whose content differs from (or is absent in)
    ``prev``, and their bytes: what a shard-granular transfer would move.
    ``prev`` None marks everything changed."""
    prev = prev or {}
    changed = [k for k, m in cur.items() if prev.get(k, {}).get("sha") != m["sha"]]
    return changed, sum(int(cur[k]["bytes"]) for k in changed)


def load_hash_table(payload_dir: str, rank: int) -> dict | None:
    try:
        with open(hash_table_path(payload_dir, rank), encoding="utf-8") as f:
            table = json.load(f)
        return table if isinstance(table, dict) else None
    except (OSError, ValueError):
        return None


def _remove_sidecars(payload_dir: str) -> None:
    prefix = os.path.basename(payload_dir) + ".rank-"
    parent = os.path.dirname(payload_dir)
    for entry in os.listdir(parent):
        if entry.startswith(prefix) and entry.endswith(".sha256.json"):
            try:
                os.remove(os.path.join(parent, entry))
            except OSError:
                pass


def _referenced_payloads(name: str) -> set[str]:
    """Payload dirs the registry's complete checkpoints point to."""
    root = env.checkpoint_path()
    refs = set()
    for _, _, ckpt in checkpoint._list_checkpoints(root):
        try:
            with open(os.path.join(ckpt, name), encoding="utf-8") as f:
                refs.add(json.load(f)["payload_dir"])
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return refs


class ShardedTrainerCheckpoint(checkpoint.State):
    """A per-rank checkpoint of a ZeRO-mode :class:`ElasticTrainer`'s
    rows (zero1, zero3, zero3_blocks); see the module docstring.

    Args:
      name: registry key.
      trainer: the ZeRO-mode ElasticTrainer.
      get_state/set_state: the TrainState accessors, as for
        ``trainer.make_checkpoint_state``.
    """

    def __init__(self, name: str, trainer, get_state: Callable[[], Any],
                 set_state: Callable[[Any], None]):
        if trainer.zero_mode is None:
            raise ValueError(
                "ShardedTrainerCheckpoint holds a ZeRO mode's rows; a "
                "dense trainer's replicated state uses TrainerCheckpoint"
            )
        super().__init__(name)
        self._trainer = trainer
        self._get_state = get_state
        self._set_state = set_state
        self._pointer: dict | None = None
        self._prev_hash_table: dict | None = None

    def sync(self) -> None:
        """Every rank writes its rows into a fresh payload dir (named by
        rank 0), with its index and sidecar, and waits for the others,
        so that rank 0's pointer never names an incomplete payload."""
        trainer = self._trainer
        state = self._get_state()
        rank, dp = trainer.mesh.index(pmesh.DATA_AXIS), trainer.num_replicas
        path = None
        if env.replica_rank() == 0:
            keep = _referenced_payloads(self.name)
            for _, _, old in _list_payload_dirs(self.name):
                if os.path.basename(old) not in keep:
                    shutil.rmtree(old, ignore_errors=True)
                    _remove_sidecars(old)
            path = _next_payload_dir(self.name)
        path = collective.broadcast(path)
        if trainer.mesh.index(pmesh.SEQ_AXIS) != 0:
            # The seq ranks of a data row hold the same rows: the first
            # writes them.
            collective.barrier()
            return
        os.makedirs(path, exist_ok=True)
        families = {
            k: v.detach().float().cpu().numpy()
            for k, v in trainer.row_families(state).items()
        }
        faults.maybe_fail("ckpt.sharded.payload")
        offsets, offset = {}, 0
        with open(os.path.join(path, f"rank-{rank}.bin"), "wb") as f:
            for key, data in families.items():
                offsets[key] = offset
                f.write(memoryview(np.ascontiguousarray(data)))
                offset += data.nbytes
            f.flush()
            os.fsync(f.fileno())
        index = {
            "rank": rank,
            "dp": dp,
            "row_len": trainer.layout.row_len(dp),
            "segments": trainer.layout.segments(rank, dp),
            "offsets": offsets,
        }
        with open(os.path.join(path, f"rank-{rank}.json"), "w", encoding="utf-8") as f:
            json.dump(index, f)
            f.flush()
            os.fsync(f.fileno())
        table = shard_hash_table(families, rank)
        changed, changed_bytes = diff_shard_tables(self._prev_hash_table, table)
        self._prev_hash_table = table
        with open(hash_table_path(path, rank), "w", encoding="utf-8") as f:
            json.dump(table, f)
            f.flush()
            os.fsync(f.fileno())
        small = trainer.small_state(state)
        self._pointer = {
            "version": 1,
            "payload_dir": os.path.basename(path),
            "dp": dp,
            "families": list(families),
            "payload_nbytes": offset * dp,
            "shard_delta": {
                "shards_total": len(table),
                "shards_changed": len(changed),
                "changed_bytes": int(changed_bytes),
            },
            "small": _jsonable(small),
        }
        collective.barrier()

    def snapshot(self) -> bytes:
        if self._pointer is None:
            raise RuntimeError("sync() writes the payload before the snapshot")
        pointer, self._pointer = self._pointer, None
        return json.dumps(pointer, sort_keys=True).encode()

    def load(self, fileobj) -> None:
        pointer = json.loads(fileobj.read())
        trainer = self._trainer
        small = pointer["small"]
        if list(small["param_names"]) != trainer.layout.names:
            raise ValueError(
                "the sharded checkpoint holds other parameters than this "
                "trainer's"
            )
        trainer.check_group_ids(small.get("group_ids"))
        path = os.path.join(_sharded_root(), pointer["payload_dir"])
        saved_dp = int(pointer["dp"])
        reader = _PayloadReader(path, saved_dp)
        dp, rank = trainer.num_replicas, trainer.mesh.index(pmesh.DATA_AXIS)
        layout = trainer.layout
        if trainer.zero1 and not trainer.zero3:
            # zero1 keeps every parameter: the whole canonical range.
            param_segments = [(0, layout.n, 0)]
            param_len = layout.row_len(dp) * dp
        else:
            param_segments = layout.segments(rank, dp)
            param_len = layout.row_len(dp)
        rows = {}
        for family in pointer["families"]:
            if family == "params":
                rows[family] = reader.read(family, param_segments, param_len)
            else:
                rows[family] = reader.read(
                    family, layout.segments(rank, dp), layout.row_len(dp)
                )
        self._prev_hash_table = load_hash_table(path, rank)
        trainer.install_rows(rows, small.get("optimizer_step"))
        carry, valid = trainer.restored_carry(
            small["layout"], rows.get("prev_grad"),
            small["gns"]["prev_grad_valid"],
        )
        state = trainer.restored_state(self._get_state(), _tensors(small), carry, valid)
        self._set_state(state)
        trainer._restored_state = state


class _PayloadReader:
    """Reads canonical ranges of one family out of a payload dir's rank
    files, each file's family checked against its sha256 sidecar before
    its first use."""

    def __init__(self, path: str, dp: int):
        self._path = path
        self._index = []
        for r in range(dp):
            with open(os.path.join(path, f"rank-{r}.json"), encoding="utf-8") as f:
                self._index.append(json.load(f))
        self._checked: set[tuple[int, str]] = set()

    def _verify(self, r: int, family: str) -> None:
        if (r, family) in self._checked:
            return
        table = load_hash_table(self._path, r)
        entry = (table or {}).get(f"{family}@{r}")
        if entry is None:
            raise checkpoint.CheckpointUnreadableError(
                f"{self._path}: rank {r} has no sha256 for {family!r}"
            )
        digest = hashlib.sha256()
        offset = self._index[r]["offsets"][family]
        left = int(entry["bytes"])
        with open(os.path.join(self._path, f"rank-{r}.bin"), "rb") as f:
            f.seek(offset)
            while left:
                chunk = f.read(min(left, _CHUNK))
                if not chunk:
                    break
                digest.update(chunk)
                left -= len(chunk)
        if left or digest.hexdigest() != entry["sha"]:
            raise checkpoint.CheckpointUnreadableError(
                f"{self._path}: rank {r}'s {family!r} fails its sha256"
            )
        self._checked.add((r, family))

    def read(self, family: str, segments: list, length: int) -> torch.Tensor:
        """A row of ``length`` float32 (zeros where no segment lies)
        holding the canonical ``segments`` ``(start, length, offset)``."""
        out = np.zeros(length, np.float32)
        for r, index in enumerate(self._index):
            pieces = []
            for start, count, offset in segments:
                for s_start, s_count, s_offset in index["segments"]:
                    lo = max(start, s_start)
                    hi = min(start + count, s_start + s_count)
                    if lo < hi:
                        pieces.append((offset + lo - start, s_offset + lo - s_start, hi - lo))
            if not pieces:
                continue
            self._verify(r, family)
            base = index["offsets"][family]
            with open(os.path.join(self._path, f"rank-{r}.bin"), "rb") as f:
                for dst, src, count in pieces:
                    f.seek(base + 4 * src)
                    f.readinto(memoryview(out[dst : dst + count]).cast("B"))
        return torch.from_numpy(out)


def _jsonable(small: dict) -> dict:
    """The small state as JSON values (float32 values round-trip
    exactly through Python floats)."""
    out = {}
    for key, value in small.items():
        if isinstance(value, dict):
            out[key] = _jsonable(value)
        elif isinstance(value, torch.Tensor):
            out[key] = value.detach().cpu().tolist()
        else:
            out[key] = value
    return out


def _tensors(small: dict) -> dict:
    """The pointer's small state back as tensors of their dtypes."""
    gns_fields = {}
    for key, value in small["gns"].items():
        dtype = torch.bool if key in ("ema_is_biased", "prev_grad_valid") else torch.float32
        gns_fields[key] = torch.tensor(value, dtype=dtype)
    return {
        "gns": gns_fields,
        "progress": torch.tensor(small["progress"], dtype=torch.float32),
        "step": torch.tensor(small["step"], dtype=torch.int64),
        "seed": small["seed"],
    }
