"""Partitioned supervisor shards for the control plane.

The port's copy of ``adaptdl_tpu.sched.shard``. One supervisor process
is the throughput and availability ceiling of the whole control plane:
every heartbeat, hint post, trace flush and allocator cycle goes through
its one server, one journal and one lease sweeper. This module
partitions :class:`ClusterState` by **tenant** (the ``namespace`` half
of a ``namespace/name`` job key) across N full supervisors. Each shard
owns its journal, snapshot cycle, lease sweeper and watch store, so a
shard crash is exactly the single-supervisor crash the durability layer
already survives: the shard replays its acknowledged journal prefix
while its workers ride out the restart on the retrying rpc client, with
zero job restarts, and sibling shards never notice.

The pieces:

- :func:`rendezvous_shard`: highest-random-weight hashing of a
  partition key over the shard ids. sha256, never the process-seeded
  ``hash()``, so every process agrees; adding or removing a shard moves
  only the tenants whose winning shard changed.
- :class:`ShardMap`: the ``{version, shards}`` record the router serves
  and reloads, written atomically (tmp + fsync + rename) through the
  ``shard.map.write`` fault point, so a torn map is never observed.
- :class:`SupervisorShard`: one shard, its own ``ClusterState`` (own
  ``state_dir``, own journal) behind its own :class:`Supervisor` on a
  **stable port**, so a killed shard recovers at the address the map
  already names.
- :class:`ShardedCluster`: N shards plus the map; partitions the slice
  inventory, routes job creation, grows and drains the shard set live,
  and exposes ``kill_shard`` / ``restart_shard``.
- :func:`merged_inventory` / :func:`plan_inventory_rebalance`: the
  allocator-facing merged view over every shard's ``GET
  /shard/inventory``.
- :func:`plan_reshard`, :func:`migrate_tenant`, :func:`run_reshard`:
  live tenant migration, journal-streamed with zero restarts.

The map, the plan and the stream batches are the JAX package's payloads,
byte for byte, so either package's router and shards read the other's.
"""

from __future__ import annotations

import hashlib
import json
import os
import time

from adaptdl_tpu_torch import env, faults, rpc
from adaptdl_tpu_torch.launch import pick_unused_port
from adaptdl_tpu_torch.sched.state import ClusterState
from adaptdl_tpu_torch.sched.supervisor import Supervisor


def shard_key(job_key: str) -> str:
    """The partition key: the tenant (namespace) half of
    ``namespace/name``. Whole tenants live on one shard, so tenant
    fairness, per-tenant SLO burn, and the watch store's tenant
    series never need cross-shard reconstruction."""
    return job_key.split("/", 1)[0]


def rendezvous_shard(partition_key: str, shard_ids) -> int:
    """Highest-random-weight shard for ``partition_key``.

    sha256 over ``"{sid}|{key}"`` — stable across processes and
    Python versions (never the process-seeded builtin ``hash``), and
    the HRW property gives minimal remap: a shard joining or leaving
    only moves the keys it wins or held."""
    best_id: int | None = None
    best_score: int | None = None
    for sid in shard_ids:
        digest = hashlib.sha256(
            f"{sid}|{partition_key}".encode()
        ).digest()
        score = int.from_bytes(digest[:16], "big")
        if (
            best_score is None
            or score > best_score
            # Ties (astronomically unlikely) break toward the lowest
            # id so the assignment stays a pure function of the set.
            or (score == best_score and sid < best_id)
        ):
            best_id, best_score = sid, score
    if best_id is None:
        raise ValueError("rendezvous over an empty shard set")
    return best_id


def partition_slices(slice_names, shard_ids) -> dict[int, list[str]]:
    """Deterministic slice → shard partition, rendezvous-hashed like
    tenants so a shard-set change moves the minimal slice set."""
    out: dict[int, list[str]] = {sid: [] for sid in shard_ids}
    for name in sorted(slice_names):
        out[rendezvous_shard(name, shard_ids)].append(name)
    return out


class ShardMap:
    """The journaled tenant → shard routing record.

    A plain ``{version, shards: {id: url}}`` payload (wire family
    ``shard_map``): routers hold it in memory, journal it to disk on
    every change, and reload it when a forward fails — the stale-map
    retry path. ``version`` increases monotonically so a reload can
    tell "newer map" from "same map, shard actually down".

    Live resharding adds two optional fields: ``overrides`` pins a
    tenant to an explicit shard (a migration in flight keeps the
    tenant on its current owner even when rendezvous already says
    otherwise — the per-tenant flip retargets or drops the pin), and
    ``retiring`` lists shards being drained: they keep serving their
    pinned tenants but win no new ones in the rendezvous."""

    def __init__(
        self,
        shards: dict[int, str],
        version: int = 1,
        overrides: dict[str, int] | None = None,
        retiring=(),
    ):
        self.version = int(version)
        self.shards = {int(sid): url for sid, url in shards.items()}
        self.overrides = {
            str(tenant): int(sid)
            for tenant, sid in (overrides or {}).items()
        }
        self.retiring = tuple(sorted(int(sid) for sid in retiring))

    def shard_ids(self) -> list[int]:
        return sorted(self.shards)

    def active_ids(self) -> list[int]:
        """Shards eligible to WIN tenants: the shard set minus the
        retiring ones (a draining shard still serves what it holds,
        it just stops winning). Falls back to the full set if every
        shard were marked retiring."""
        retiring = set(self.retiring)
        active = [sid for sid in sorted(self.shards) if sid not in retiring]
        return active or sorted(self.shards)

    def assign(self, job_key: str) -> int:
        """Owning shard id for a job key: the tenant's explicit pin
        if one exists, else rendezvous over the active shard set."""
        tenant = shard_key(job_key)
        pinned = self.overrides.get(tenant)
        if pinned is not None and pinned in self.shards:
            return pinned
        return rendezvous_shard(tenant, self.active_ids())

    def url_for(self, job_key: str) -> str:
        return self.shards[self.assign(job_key)]

    def to_payload(self) -> dict:
        # JSON object keys are strings; ``from_payload`` restores the
        # int ids. ``overrides``/``retiring`` stay absent when empty
        # so pre-resharding readers see the exact legacy payload.
        payload = {
            "version": self.version,
            "shards": {
                str(sid): self.shards[sid]
                for sid in sorted(self.shards)
            },
        }
        if self.overrides:
            payload["overrides"] = dict(sorted(self.overrides.items()))
        if self.retiring:
            payload["retiring"] = list(self.retiring)
        return payload

    @classmethod
    def from_payload(cls, payload: dict) -> "ShardMap":
        return cls(
            {
                int(sid): url
                for sid, url in payload["shards"].items()
            },
            version=payload["version"],
            overrides=payload.get("overrides") or {},
            retiring=payload.get("retiring") or (),
        )

    def save(self, path: str) -> None:
        """Atomic write+fsync+rename — a crashed writer leaves either
        the old complete map or the new complete map, never a torn
        one. The ``shard.map.write`` fault point aborts BEFORE the
        rename, so an injected fault keeps the previous version
        served."""
        faults.maybe_fail("shard.map.write")
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_payload(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ShardMap":
        with open(path) as f:
            return cls.from_payload(json.load(f))


class SupervisorShard:
    """One shard of the partitioned control plane: a full supervisor
    (own journal, snapshot cycle, lease sweeper, watch store) bound
    to a **stable port**, so the shard map entry survives a
    kill/recover cycle.

    ``state_dir=None`` runs in-memory (bench arms); a real directory
    makes the shard durable — ``kill()`` then ``start()`` replays the
    acknowledged journal prefix exactly like a supervisor restart."""

    def __init__(
        self,
        shard_id: int,
        state_dir: str | None = None,
        host: str = "127.0.0.1",
        port: int | None = None,
        slices=(),
        lease_ttl: float | None = None,
        sweep_interval: float | None = None,
        state_kwargs: dict | None = None,
    ):
        self.shard_id = int(shard_id)
        self._state_dir = state_dir
        self._host = host
        self._port = port if port is not None else pick_unused_port()
        self.slices = list(slices)
        self._lease_ttl = lease_ttl
        self._sweep_interval = sweep_interval
        self._state_kwargs = dict(state_kwargs or {})
        self.state: ClusterState | None = None
        self.supervisor: Supervisor | None = None

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}"

    @property
    def alive(self) -> bool:
        return self.supervisor is not None

    def start(self) -> str:
        """(Re)start the shard. With a ``state_dir``, construction IS
        recovery: ``ClusterState`` replays snapshot+journal before
        the supervisor serves its first request."""
        if self.supervisor is not None:
            return self.url
        self.state = ClusterState(
            state_dir=self._state_dir, **self._state_kwargs
        )
        self.supervisor = Supervisor(
            self.state,
            host=self._host,
            port=self._port,
            lease_ttl=self._lease_ttl,
            sweep_interval=self._sweep_interval,
            shard_id=self.shard_id,
            slices_fn=lambda: list(self.slices),
        )
        return self.supervisor.start()

    def stop(self) -> None:
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None

    def kill(self) -> None:
        """Hard-kill: stop serving and DROP the in-memory state, as a
        crashed process would. Durable shards recover everything the
        journal acknowledged on the next ``start()``; in-memory
        shards come back empty (a deliberate data loss the caller
        opted into by passing no ``state_dir``)."""
        self.stop()
        self.state = None


class ShardedCluster:
    """N supervisor shards plus their shard map — the process-level
    partition of one logical cluster.

    ``shard_count=1`` is the provably-unchanged special case: one
    shard owns every tenant and every slice, and the deployment is
    bit-identical to the classic unsharded supervisor (the
    equivalence test pins this)."""

    def __init__(
        self,
        shard_count: int | None = None,
        state_root: str | None = None,
        host: str = "127.0.0.1",
        slices=(),
        lease_ttl: float | None = None,
        sweep_interval: float | None = None,
        state_kwargs: dict | None = None,
        map_path: str | None = None,
    ):
        count = (
            shard_count
            if shard_count is not None
            else (env.shard_count() or 1)
        )
        if count < 1:
            raise ValueError(f"shard_count must be >= 1: {count}")
        shard_ids = list(range(count))
        by_shard = partition_slices(slices, shard_ids)
        # Kept for grow(): a new shard is built with the same knobs
        # its siblings got.
        self._state_root = state_root
        self._host = host
        self._lease_ttl = lease_ttl
        self._sweep_interval = sweep_interval
        self._state_kwargs = state_kwargs
        self.shards: dict[int, SupervisorShard] = {}
        for sid in shard_ids:
            state_dir = (
                os.path.join(state_root, f"shard-{sid}")
                if state_root is not None
                else None
            )
            self.shards[sid] = SupervisorShard(
                sid,
                state_dir=state_dir,
                host=host,
                slices=by_shard[sid],
                lease_ttl=lease_ttl,
                sweep_interval=sweep_interval,
                state_kwargs=state_kwargs,
            )
        self._map_path = (
            map_path if map_path is not None else env.shard_map_path()
        )
        self.map: ShardMap | None = None

    def start(self) -> ShardMap:
        for shard in self.shards.values():
            shard.start()
        self.map = ShardMap(
            {sid: shard.url for sid, shard in self.shards.items()}
        )
        if self._map_path:
            self.map.save(self._map_path)
        return self.map

    def stop(self) -> None:
        for shard in self.shards.values():
            shard.stop()

    def shard_for(self, job_key: str) -> SupervisorShard:
        if self.map is None:
            raise RuntimeError("cluster not started")
        return self.shards[self.map.assign(job_key)]

    def create_job(self, key: str, spec: dict | None = None):
        """Create a job on its owning shard (control-plane-local: job
        admission happens beside the journal that owns the key)."""
        shard = self.shard_for(key)
        if shard.state is None:
            raise RuntimeError(f"shard {shard.shard_id} is down")
        return shard.state.create_job(key, spec)

    def kill_shard(self, shard_id: int) -> None:
        self.shards[shard_id].kill()

    def restart_shard(self, shard_id: int) -> str:
        return self.shards[shard_id].start()

    def _publish_map(self, new_map: "ShardMap") -> "ShardMap":
        self.map = new_map
        if self._map_path:
            new_map.save(self._map_path)
        return new_map

    def grow(
        self,
        client: rpc.RpcClient | None = None,
        fence_s: float | None = None,
    ) -> "ReshardPlan":
        """N → N+1 live grow, zero restarts: start the new shard,
        publish a map that ADDS it with every moving tenant pinned to
        its current owner (so the publish changes no routing), then
        live-migrate each pinned tenant — one flip per tenant — and
        finish by rebalancing the slice partition toward the new job
        shares."""
        if self.map is None:
            raise RuntimeError("cluster not started")
        new_sid = max(self.shards) + 1
        shard = SupervisorShard(
            new_sid,
            state_dir=(
                os.path.join(self._state_root, f"shard-{new_sid}")
                if self._state_root is not None
                else None
            ),
            host=self._host,
            lease_ttl=self._lease_ttl,
            sweep_interval=self._sweep_interval,
            state_kwargs=self._state_kwargs,
        )
        shard.start()
        self.shards[new_sid] = shard
        urls = {sid: s.url for sid, s in self.shards.items()}
        plan = plan_reshard(self.map, new_shards=urls, client=client)
        overrides = dict(self.map.overrides)
        for move in plan.moves:
            overrides[move["tenant"]] = move["from"]
        self._publish_map(
            ShardMap(
                urls,
                version=self.map.version + 1,
                overrides=overrides,
                retiring=self.map.retiring,
            )
        )
        for move in plan.moves:
            # migrate_tenant journals the flipped map ITSELF, before
            # its commit tail plants the source's 409 marker — a
            # router reloading on that 409 must already find the new
            # version on disk. _publish_map then syncs self.map.
            self._publish_map(
                migrate_tenant(
                    self.map,
                    move["tenant"],
                    move["from"],
                    move["to"],
                    map_path=self._map_path,
                    client=client,
                    fence_s=fence_s,
                )
            )
        self.rebalance_slices(client=client)
        return plan

    def drain(
        self,
        shard_id: int,
        client: rpc.RpcClient | None = None,
        fence_s: float | None = None,
    ) -> "ReshardPlan":
        """N+1 → N drain-and-retire, zero restarts: publish the shard
        as retiring (it keeps serving its pinned tenants but wins no
        new ones), live-migrate each of its tenants to the rendezvous
        winner among the survivors, then publish the final map
        without it, re-home its slices, and stop it."""
        if self.map is None:
            raise RuntimeError("cluster not started")
        sid = int(shard_id)
        survivors = sorted(s for s in self.shards if s != sid)
        if not survivors:
            raise ValueError("cannot drain the last shard")
        plan = plan_reshard(self.map, retiring=(sid,), client=client)
        overrides = dict(self.map.overrides)
        for move in plan.moves:
            overrides[move["tenant"]] = move["from"]
        urls = {s: sh.url for s, sh in self.shards.items()}
        self._publish_map(
            ShardMap(
                urls,
                version=self.map.version + 1,
                overrides=overrides,
                retiring=tuple(set(self.map.retiring) | {sid}),
            )
        )
        for move in plan.moves:
            # As in grow(): the flip must hit the journaled map file
            # BEFORE the source starts answering 409 ``moved``.
            self._publish_map(
                migrate_tenant(
                    self.map,
                    move["tenant"],
                    move["from"],
                    move["to"],
                    map_path=self._map_path,
                    client=client,
                    fence_s=fence_s,
                )
            )
        # Retire: the drained shard leaves the map; pins that now
        # match plain rendezvous over the survivors are pruned.
        remaining = {s: sh.url for s, sh in self.shards.items() if s != sid}
        retiring = tuple(s for s in self.map.retiring if s != sid)
        active = sorted(set(remaining) - set(retiring)) or sorted(remaining)
        final_overrides = {
            tenant: owner
            for tenant, owner in self.map.overrides.items()
            if owner in remaining
            and owner != rendezvous_shard(tenant, active)
        }
        self._publish_map(
            ShardMap(
                remaining,
                version=self.map.version + 1,
                overrides=final_overrides,
                retiring=retiring,
            )
        )
        # Re-home the retired shard's slices before it goes away.
        leftovers = list(self.shards[sid].slices)
        self.shards[sid].slices = []
        for osid, names in partition_slices(leftovers, survivors).items():
            self.shards[osid].slices.extend(names)
        self.shards[sid].stop()
        del self.shards[sid]
        return plan

    def rebalance_slices(
        self, client: rpc.RpcClient | None = None
    ) -> list[dict]:
        """Apply :func:`plan_inventory_rebalance`'s slice moves to the
        live shard slice sets (the allocator's merged view follows on
        its next full cycle). Returns the moves applied."""
        if self.map is None:
            raise RuntimeError("cluster not started")
        merged = merged_inventory(self.map, client=client)
        moves = plan_inventory_rebalance(merged)
        for move in moves:
            src = self.shards.get(move["from"])
            dst = self.shards.get(move["to"])
            if src is None or dst is None:
                continue
            if move["slice"] in src.slices:
                src.slices.remove(move["slice"])
                dst.slices.append(move["slice"])
        return moves


def merged_inventory(
    shard_map: ShardMap, client: rpc.RpcClient | None = None
) -> dict:
    """The allocator's cross-shard view: every shard's
    ``GET /shard/inventory`` slice, merged. Jobs and slices map to
    their owning shard id; the dirty-job union is what a merged full
    cycle would re-optimize. Per-shard incremental cycles never need
    this — only full cycles (and the rebalance planner below) do."""
    client = client if client is not None else rpc.default_client()
    shards_seen: list[int] = []
    jobs: dict[str, int] = {}
    dirty: list[str] = []
    slices: dict[str, int] = {}
    for sid in shard_map.shard_ids():
        url = shard_map.shards[sid]
        inv = client.get(
            f"{url}/shard/inventory",
            endpoint=f"shard{sid}/inventory",
            timeout=5,
            attempts=3,
            deadline=15.0,
        ).json()
        shard = inv["shard"]
        shards_seen.append(shard)
        for key in inv["jobs"]:
            jobs[key] = shard
        dirty.extend(inv["dirtyJobs"])
        for name in inv["slices"]:
            slices[name] = shard
    return {
        "shards": shards_seen,
        "jobs": jobs,
        "dirtyJobs": sorted(set(dirty)),
        "slices": slices,
    }


def plan_inventory_rebalance(merged: dict) -> list[dict]:
    """Pure full-cycle planning over a merged inventory: propose
    slice moves so each shard's slice share tracks its job share.

    Deterministic (sorted iteration, largest-deficit-first) so the
    same merged view always yields the same plan; returns
    ``[{"slice", "from", "to"}]`` moves, empty when balanced. The
    caller (an operator, or a future expander hook) applies moves by
    editing shard slice sets — this function never mutates."""
    shard_ids = sorted(merged["shards"])
    if not shard_ids:
        return []
    jobs_per = {sid: 0 for sid in shard_ids}
    for owner in merged["jobs"].values():
        if owner in jobs_per:
            jobs_per[owner] += 1
    slices_per: dict[int, list[str]] = {sid: [] for sid in shard_ids}
    for name, owner in sorted(merged["slices"].items()):
        if owner in slices_per:
            slices_per[owner].append(name)
    total_slices = sum(len(v) for v in slices_per.values())
    total_jobs = sum(jobs_per.values())
    if total_slices == 0:
        return []
    # Target: proportional to job count; an idle shard keeps zero
    # target but never gives up its LAST slice unless another shard
    # has jobs and none (largest-remainder rounding keeps the sum
    # exact).
    if total_jobs == 0:
        return []
    quotas = {
        sid: total_slices * jobs_per[sid] / total_jobs
        for sid in shard_ids
    }
    targets = {sid: int(quotas[sid]) for sid in shard_ids}
    remainder = total_slices - sum(targets.values())
    for sid in sorted(
        shard_ids,
        key=lambda s: (-(quotas[s] - targets[s]), s),
    )[:remainder]:
        targets[sid] += 1
    surplus: list[tuple[int, str]] = []
    for sid in shard_ids:
        extra = len(slices_per[sid]) - targets[sid]
        # Give up the lexicographically-last slices so the kept
        # prefix is stable run over run.
        for name in slices_per[sid][len(slices_per[sid]) - extra:]:
            surplus.append((sid, name))
    moves: list[dict] = []
    deficits = [
        sid
        for sid in sorted(
            shard_ids,
            key=lambda s: (len(slices_per[s]) - targets[s], s),
        )
        if len(slices_per[sid]) < targets[sid]
    ]
    for sid in deficits:
        need = targets[sid] - len(slices_per[sid])
        while need > 0 and surplus:
            src, name = surplus.pop(0)
            moves.append({"slice": name, "from": src, "to": sid})
            need -= 1
    return moves


# ---------------------------------------------------------------------------
# Live resharding: journal-streamed tenant migration with zero restarts.
# ---------------------------------------------------------------------------


class ReshardError(RuntimeError):
    """A live tenant migration failed and was ROLLED BACK: the map
    version was not bumped, the destination's partial tenant epoch was
    discarded, and the source shard is still authoritative."""


class ReshardPlan:
    """The journaled live-migration plan (wire family ``reshard``,
    versioned like ``shard_map``): the map version it was computed
    against, the ordered tenant moves, and any shards being retired.
    Written atomically (tmp + fsync + rename) like the map, so a
    coordinator crash leaves either the whole plan or none."""

    def __init__(
        self, moves, from_version: int, retiring=(), shards=None
    ):
        self.from_version = int(from_version)
        self.moves = [
            {
                "tenant": str(m["tenant"]),
                "from": int(m["from"]),
                "to": int(m["to"]),
            }
            for m in moves
        ]
        self.retiring = tuple(sorted(int(s) for s in retiring))
        # The target shard URL set the plan was cut against — what a
        # standalone ``reshard apply`` needs to widen the journaled
        # map with a grown shard before the first migration.
        self.shards = {
            int(sid): str(url) for sid, url in (shards or {}).items()
        }

    @property
    def version(self) -> int:
        """The map version the final flip lands on: one bump per
        tenant move on top of the version the plan was cut from."""
        return self.from_version + len(self.moves)

    def to_payload(self) -> dict:
        return {
            "version": self.version,
            "fromVersion": self.from_version,
            "moves": list(self.moves),
            "retiring": list(self.retiring),
            "shards": {
                str(sid): self.shards[sid]
                for sid in sorted(self.shards)
            },
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "ReshardPlan":
        return cls(
            payload["moves"],
            from_version=int(payload.get("fromVersion") or 0),
            retiring=payload.get("retiring") or (),
            shards=payload.get("shards") or {},
        )

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_payload(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ReshardPlan":
        with open(path) as f:
            return cls.from_payload(json.load(f))


def plan_reshard(
    shard_map: ShardMap,
    new_shards: dict[int, str] | None = None,
    retiring=(),
    merged: dict | None = None,
    client: rpc.RpcClient | None = None,
) -> ReshardPlan:
    """Compute the tenant moves a shard-set change implies.

    The moves are the rendezvous deltas between the current map's
    assignment and plain rendezvous over the target active set
    (``new_shards`` minus ``retiring``), restricted to tenants that
    actually hold jobs per the merged inventory — an empty tenant has
    nothing to stream and re-routes for free on the next map publish."""
    if merged is None:
        merged = merged_inventory(shard_map, client=client)
    target = ShardMap(
        new_shards if new_shards is not None else shard_map.shards,
        retiring=tuple(set(retiring) | set(shard_map.retiring)),
    )
    # Source = the shard that ACTUALLY holds the tenant per the
    # inventory (tenants partition, so all of a tenant's keys share
    # one owner) — robust even against a stale in-memory map.
    holder: dict[str, int] = {}
    for key, owner in sorted(merged["jobs"].items()):
        holder.setdefault(shard_key(key), int(owner))
    moves = []
    for tenant in sorted(holder):
        src = holder[tenant]
        dst = rendezvous_shard(tenant, target.active_ids())
        if src != dst:
            moves.append({"tenant": tenant, "from": src, "to": dst})
    return ReshardPlan(
        moves,
        from_version=shard_map.version,
        retiring=retiring,
        shards=target.shards,
    )


def _flip_map(shard_map: ShardMap, tenant: str, to_sid: int) -> ShardMap:
    """The successor map for one tenant flip: version + 1 with the
    tenant's pin retargeted to the destination — or dropped entirely
    when plain rendezvous already lands there."""
    overrides = dict(shard_map.overrides)
    if rendezvous_shard(tenant, shard_map.active_ids()) == int(to_sid):
        overrides.pop(tenant, None)
    else:
        overrides[tenant] = int(to_sid)
    return ShardMap(
        shard_map.shards,
        version=shard_map.version + 1,
        overrides=overrides,
        retiring=shard_map.retiring,
    )


def migrate_tenant(
    shard_map: ShardMap,
    tenant: str,
    from_sid: int,
    to_sid: int,
    map_path: str | None = None,
    client: rpc.RpcClient | None = None,
    fence_s: float | None = None,
    max_catchup_batches: int = 10_000,
) -> ShardMap:
    """Live-migrate one tenant between shards with zero job restarts.

    The state machine, every step idempotent and crash-recoverable:

    1. **bootstrap / resume** — if the destination already holds this
       epoch (a crashed coordinator re-running), resume from its acked
       watermark; else import the source's snapshot export.
    2. **catch-up** — stream the source's tenant-scoped journal tail
       (``GET /shard/stream/{tenant}?from_seq=``, sha-verified,
       seq-ordered) into the destination until a delta batch comes
       back empty. The source keeps serving throughout.
    3. **fence** — raise a bounded per-tenant write fence on the
       source (``ADAPTDL_RESHARD_FENCE_S``; workers ride out the brief
       503s on the retrying rpc client) and drain the final delta.
       Overrunning the fence budget aborts.
    4. **verify** — both sides' full tenant exports must hash equal.
    5. **flip** — bump the map version with the tenant's pin
       retargeted (the ``reshard.flip`` fault fires BEFORE anything
       irreversible), then commit: the destination promotes its
       pending epoch, the source drops the tenant and starts answering
       409 ``moved`` so stale-map workers re-forward exactly once.

    Any failure before the flip ROLLS BACK: both sides abort the
    epoch, the source is unfenced and stays authoritative, and the map
    version is never bumped. A coordinator crash after the flip is
    repaired by re-running — the map already names the destination, so
    only the idempotent commit tail is replayed.

    Returns the flipped map (version + 1); raises
    :class:`ReshardError` after rollback."""
    client = client if client is not None else rpc.default_client()
    fence_s = float(fence_s) if fence_s is not None else env.reshard_fence_s()
    from_sid, to_sid = int(from_sid), int(to_sid)
    src = shard_map.shards[from_sid]
    dst = shard_map.shards[to_sid]
    # Deterministic epoch: a crashed coordinator re-running the same
    # plan against the same map derives the same epoch and resumes
    # instead of restarting from scratch.
    epoch = f"{tenant}:{from_sid}->{to_sid}@v{shard_map.version}"

    def post(base, verb, body):
        resp = client.post(
            f"{base}/shard/reshard/{verb}/{tenant}",
            json=body,
            endpoint=f"reshard/{verb}",
            timeout=(2, 10),
            attempts=4,
            deadline=30.0,
        )
        if resp.status_code != 200:
            raise ReshardError(
                f"reshard {verb} for {tenant!r} on {base} failed: "
                f"HTTP {resp.status_code} {resp.text[:200]}"
            )
        return resp.json()

    def pull(base, from_seq):
        resp = client.get(
            f"{base}/shard/stream/{tenant}",
            params=(
                None if from_seq is None else {"from_seq": int(from_seq)}
            ),
            endpoint="reshard/stream",
            timeout=(2, 10),
            attempts=4,
            deadline=30.0,
        )
        if resp.status_code != 200:
            raise ReshardError(
                f"reshard stream for {tenant!r} on {base} failed: "
                f"HTTP {resp.status_code} {resp.text[:200]}"
            )
        return resp.json()

    def finish(flipped: ShardMap) -> ShardMap:
        # Idempotent commit tail: destination promotes first, THEN the
        # source drops the tenant — a crash between the two leaves
        # both shards holding it, and the bumped map already routes to
        # the destination while the re-run repeats both commits.
        post(dst, "commit", {"epoch": epoch, "role": "dest"})
        post(
            src,
            "commit",
            {
                "epoch": epoch,
                "role": "source",
                "toShard": to_sid,
                "mapVersion": flipped.version,
            },
        )
        return flipped

    # A crashed coordinator re-run after the flip already landed: the
    # map names the destination, so only the commit tail can be
    # outstanding.
    if shard_map.assign(f"{tenant}/-") == to_sid:
        return finish(shard_map)

    try:
        # -- bootstrap or resume -----------------------------------------
        status = client.get(
            f"{dst}/shard/reshard/status",
            endpoint="reshard/status",
            timeout=(2, 10),
            attempts=4,
            deadline=30.0,
        ).json()
        pending = (status.get("pending") or {}).get(tenant)
        if pending and pending.get("epoch") == epoch:
            watermark = int(pending["watermark"])
        else:
            batch = pull(src, None)
            watermark = int(
                post(dst, "import", dict(batch, epoch=epoch))["watermark"]
            )
        # -- unfenced catch-up -------------------------------------------
        for _ in range(max_catchup_batches):
            batch = pull(src, watermark)
            if batch["mode"] == "delta" and not batch["records"]:
                break
            watermark = int(
                post(dst, "import", dict(batch, epoch=epoch))["watermark"]
            )
        # -- fence + final drain -----------------------------------------
        faults.maybe_fail("reshard.fence")
        fence = post(src, "fence", {"deadlineS": fence_s})
        fence_deadline = time.monotonic() + float(
            fence.get("deadlineS") or fence_s
        )
        while True:
            batch = pull(src, watermark)
            if batch["mode"] == "delta" and not batch["records"]:
                # Fenced + empty delta = the destination holds every
                # mutation the source ever acknowledged for this tenant.
                break
            watermark = int(
                post(dst, "import", dict(batch, epoch=epoch))["watermark"]
            )
            if time.monotonic() > fence_deadline:
                raise ReshardError(
                    f"fence budget ({fence_s:.3f}s) overran before "
                    f"catch-up for tenant {tenant!r}"
                )
        # -- verify -------------------------------------------------------
        src_export = pull(src, None)
        dst_export = pull(dst, None)
        if src_export["sha"] != dst_export["sha"]:
            raise ReshardError(
                f"tenant {tenant!r} export sha mismatch after drain: "
                f"source {src_export['sha'][:12]} != "
                f"destination {dst_export['sha'][:12]}"
            )
        # -- flip ---------------------------------------------------------
        # The injected fault fires BEFORE the version bump so a chaos
        # kill here rolls back with the old map still authoritative.
        faults.maybe_fail("reshard.flip")
        flipped = _flip_map(shard_map, tenant, to_sid)
        if map_path:
            flipped.save(map_path)
    except (
        ReshardError,
        faults.InjectedFault,
        rpc.RpcError,
    ) as exc:
        # ROLLBACK: discard the destination's pending epoch, release
        # the source fence. Best-effort — a re-run converges either
        # way because aborts and imports are epoch-keyed.
        for base, body in (
            (dst, {"epoch": epoch, "role": "dest"}),
            (src, {"epoch": epoch, "role": "source"}),
        ):
            try:
                post(base, "abort", body)
            except (ReshardError, rpc.RpcError):
                pass
        if isinstance(exc, ReshardError):
            raise
        raise ReshardError(
            f"tenant {tenant!r} migration rolled back: {exc}"
        ) from exc
    return finish(flipped)


def run_reshard(
    shard_map: ShardMap,
    plan: ReshardPlan,
    map_path: str | None = None,
    client: rpc.RpcClient | None = None,
    fence_s: float | None = None,
) -> ShardMap:
    """Execute a :class:`ReshardPlan` move by move (the CLI's
    ``reshard apply``). Each tenant migration flips its own map
    version; a coordinator crash mid-plan re-runs idempotently —
    completed moves short-circuit on the already-flipped map."""
    current = shard_map
    for move in plan.moves:
        current = migrate_tenant(
            current,
            move["tenant"],
            move["from"],
            move["to"],
            map_path=map_path,
            client=client,
            fence_s=fence_s,
        )
    return current
