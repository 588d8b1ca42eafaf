"""Live tenant migration in the port against the JAX package.

- The cluster state's migration half (export, stream, import, commit,
  abort, fences) run by both packages from one op sequence on a frozen
  clock gives equal batches, equal ``reshard_info()`` and byte-equal
  journals; a batch either package streams, the other imports.
- Journals and snapshots holding reshard records, written by one package,
  are recovered by the other.
- ``migrate_tenant`` moves a tenant between a JAX shard and a port shard.
- ``cli shardmap`` and ``cli reshard plan|apply|status`` run against live
  port shards behind the port's router, and print what the JAX verbs
  print.
"""

from __future__ import annotations

import json
import os
import shutil
import types

import pytest

from adaptdl_tpu import cli as jax_cli
from adaptdl_tpu import faults as jax_faults
from adaptdl_tpu import rpc as jax_rpc
from adaptdl_tpu.sched import shard as jax_shard
from adaptdl_tpu.sched import state as jax_state
from adaptdl_tpu.sched import supervisor as jax_supervisor
from adaptdl_tpu_torch import cli as port_cli
from adaptdl_tpu_torch import faults as port_faults
from adaptdl_tpu_torch import rpc as port_rpc
from adaptdl_tpu_torch.sched import router as port_router
from adaptdl_tpu_torch.sched import shard as port_shard
from adaptdl_tpu_torch.sched import state as port_state
from adaptdl_tpu_torch.sched import supervisor as port_supervisor
from tests.torch_support import private_tempdir  # noqa: F401

HINTS = {"initBatchSize": 128, "maxBatchSize": 1280}

PACKAGES = {
    "jax": types.SimpleNamespace(state=jax_state, shard=jax_shard,
                                 supervisor=jax_supervisor),
    "port": types.SimpleNamespace(state=port_state, shard=port_shard,
                                  supervisor=port_supervisor),
}


@pytest.fixture(autouse=True)
def _clean_fault_state():
    for module in (jax_faults, port_faults):
        module.reset()
    for module in (jax_rpc, port_rpc):
        module.reset_default_client()
    yield
    for module in (jax_faults, port_faults):
        module.reset()
    for module in (jax_rpc, port_rpc):
        module.reset_default_client()


class _FrozenClock:
    @staticmethod
    def monotonic() -> float:
        return 1000.0

    @staticmethod
    def time() -> float:
        return 1_700_000_000.0


def _close(state):
    """Sync a state's journal (the JAX state has no ``close``: it fsyncs
    each record as it appends it)."""
    close = getattr(state, "close", None)
    if close is not None:
        close()


def _populate(state, tenant="acme", other="zeta"):
    """The source-side op sequence: two tenants' jobs, registrations,
    hints and an allocation."""
    for key in (f"{tenant}/a", f"{tenant}/b", f"{other}/c"):
        state.create_job(key, {"max_replicas": 4})
        state.update(key, hints=dict(HINTS), status="Running")
    state.register_worker(f"{tenant}/a", 0, 0, "10.0.0.1:1")
    state.update(f"{tenant}/b", allocation=["slot-0", "slot-1"])


def _migration(pkg, src_dir=None, dst_dir=None, snapshot_every=256):
    """Source and destination states run through export, a delta tail,
    the fence, both commits and an aborted second epoch; returns the
    states and every batch and answer along the way."""
    clock = _FrozenClock()
    src = pkg.state.ClusterState(
        state_dir=src_dir or "", clock=clock, snapshot_every=snapshot_every
    )
    dst = pkg.state.ClusterState(
        state_dir=dst_dir or "", clock=clock, snapshot_every=snapshot_every
    )
    trail = []
    _populate(src)
    epoch = "acme:0->1@v1"
    boot = src.stream_tenant("acme", None)
    trail.append(boot)
    trail.append(dst.reshard_import_batch("acme", epoch, dict(boot, epoch=epoch)))
    # Mutations after the bootstrap ride the delta stream.
    src.update("acme/a", hints=dict(HINTS, maxBatchSize=2048))
    src.create_job("acme/c", {"max_replicas": 2})
    src.remove_job("acme/b")
    src.update("zeta/c", status="Running")
    delta = src.stream_tenant("acme", trail[-1], limit=2)
    trail.append(delta)
    trail.append(dst.reshard_import_batch("acme", epoch, dict(delta, epoch=epoch)))
    # A re-delivered batch journals nothing.
    trail.append(dst.reshard_import_batch("acme", epoch, dict(delta, epoch=epoch)))
    rest = src.stream_tenant("acme", trail[-1])
    trail.append(rest)
    trail.append(dst.reshard_import_batch("acme", epoch, dict(rest, epoch=epoch)))
    trail.append(src.stream_tenant("acme", trail[-1]))
    trail.append(dst.reshard_info())
    src.fence_tenant("acme", 5.0)
    trail.append(src.fence_remaining("acme"))
    trail.append(src.export_tenant("acme")["sha"] == dst.export_tenant("acme")["sha"])
    trail.append(dst.reshard_commit_dest("acme", epoch))
    trail.append(dst.reshard_commit_dest("acme", epoch))
    trail.append(src.reshard_commit_source("acme", epoch, 1, 2))
    trail.append(src.reshard_commit_source("acme", epoch, 1, 2))
    trail.append(src.moved_owner("acme"))
    # A second tenant's epoch, bootstrapped and then rolled back.
    zeta = "zeta:0->1@v2"
    trail.append(dst.reshard_import_batch(
        "zeta", zeta, dict(src.stream_tenant("zeta", None), epoch=zeta)))
    trail.append(dst.reshard_watermark("zeta", zeta))
    trail.append(dst.reshard_info())
    trail.append(dst.reshard_abort("zeta", zeta))
    trail.append(dst.reshard_abort("zeta", zeta))
    trail.append(src.reshard_info())
    trail.append(dst.reshard_info())
    trail.append(sorted(dst.jobs()))
    trail.append(sorted(src.jobs()))
    return src, dst, trail


def test_migration_ops_equal_the_jax_state():
    _, _, port_trail = _migration(PACKAGES["port"])
    _, _, jax_trail = _migration(PACKAGES["jax"])
    assert json.dumps(port_trail, sort_keys=True) == json.dumps(
        jax_trail, sort_keys=True
    )
    assert port_trail[-2] == ["acme/a", "acme/c"]
    assert port_trail[-1] == ["zeta/c"]


def test_migration_journals_are_the_jax_bytes(tmp_path):
    for name, pkg in PACKAGES.items():
        src, dst, _ = _migration(
            pkg, str(tmp_path / name / "src"), str(tmp_path / name / "dst")
        )
        _close(src)
        _close(dst)
    for side in ("src", "dst"):
        files = {
            name: sorted(os.listdir(tmp_path / name / side))
            for name in PACKAGES
        }
        assert files["port"] == files["jax"]
        for fname in files["port"]:
            with open(tmp_path / "port" / side / fname, "rb") as a, open(
                tmp_path / "jax" / side / fname, "rb"
            ) as b:
                assert a.read() == b.read(), (side, fname)


def _recovered_view(pkg, root, snapshot_every, epoch):
    clock = _FrozenClock()
    src = pkg.state.ClusterState(state_dir=str(root / "src"), clock=clock,
                                 snapshot_every=snapshot_every)
    dst = pkg.state.ClusterState(state_dir=str(root / "dst"), clock=clock,
                                 snapshot_every=snapshot_every)
    view = json.dumps([
        src.reshard_info(), dst.reshard_info(),
        src.export_tenant("acme")["sha"], dst.export_tenant("acme")["sha"],
        dst.export_tenant("zeta")["sha"], dst.reshard_watermark("zeta", epoch),
        src.moved_owner("acme"),
        # The recovered ring serves the delta tail above the head.
        src.stream_tenant("zeta", src.last_journal_seq() - 2)["mode"],
    ], sort_keys=True)
    _close(src)
    _close(dst)
    return json.loads(view)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("snapshot_every", [256, 3])
def test_reshard_journals_recover_across_packages(
    tmp_path, writer, reader, snapshot_every
):
    """Each package recovers journals (and, at a short snapshot cadence,
    snapshots carrying the pending and moved tables) that the other
    wrote, to the same migration view and tenant exports."""
    root = tmp_path / "written"
    src, dst, _ = _migration(
        PACKAGES[writer], str(root / "src"), str(root / "dst"),
        snapshot_every=snapshot_every,
    )
    # A pending import the snapshot or journal must carry.
    epoch = "zeta:0->1@v3"
    dst.reshard_import_batch(
        "zeta", epoch, dict(src.stream_tenant("zeta", None), epoch=epoch)
    )
    _close(src)
    _close(dst)
    # Recovery appends a record: each package recovers its own copy.
    views = {}
    for name in (writer, reader):
        copy = tmp_path / f"copy-{name}"
        shutil.copytree(root, copy)
        views[name] = _recovered_view(PACKAGES[name], copy, snapshot_every, epoch)
    assert views[reader] == views[writer]
    view = views[reader]
    assert view[1]["pending"]["zeta"]["epoch"] == epoch
    assert view[6]["shard"] == 1
    assert view[7] == "delta"


def test_stream_batches_cross_packages():
    """A port destination imports a JAX source's batches and the other
    way round, to equal exports."""
    clock = _FrozenClock()
    for src_pkg, dst_pkg in (("jax", "port"), ("port", "jax")):
        src = PACKAGES[src_pkg].state.ClusterState(state_dir="", clock=clock)
        dst = PACKAGES[dst_pkg].state.ClusterState(state_dir="", clock=clock)
        _populate(src)
        epoch = "acme:0->1@v1"
        mark = dst.reshard_import_batch(
            "acme", epoch, dict(src.stream_tenant("acme", None), epoch=epoch)
        )
        src.update("acme/a", hints=dict(HINTS, maxBatchSize=4096))
        src.remove_job("acme/b")
        batch = json.loads(json.dumps(src.stream_tenant("acme", mark)))
        dst.reshard_import_batch("acme", epoch, dict(batch, epoch=epoch))
        assert dst.export_tenant("acme")["sha"] == src.export_tenant("acme")["sha"]
        corrupt = dict(batch, epoch=epoch, sha="0" * 64)
        with pytest.raises(ValueError, match="sha mismatch"):
            dst.reshard_import_batch("acme", epoch, corrupt)


def test_stream_falls_back_to_a_snapshot_past_the_ring():
    state = port_state.ClusterState(state_dir="", snapshot_every=1)
    _populate(state)
    for i in range(1100):
        state.update("zeta/c", hints=dict(HINTS, initBatchSize=i + 1))
    assert state.stream_tenant("acme", 1)["mode"] == "snapshot"
    head = state.last_journal_seq()
    batch = state.stream_tenant("acme", head)
    assert batch == {"mode": "delta", "records": [], "seq": head,
                     "sha": batch["sha"]}


def test_fence_and_moved_gate_on_the_supervisor():
    state = port_state.ClusterState(state_dir="")
    state.create_job("acme/a", {})
    sup = port_supervisor.Supervisor(state, lease_ttl=30.0, sweep_interval=3600.0)
    url = sup.start()
    client = port_rpc.RpcClient()

    def call(method, path, **kwargs):
        return client.request(method, f"{url}{path}", endpoint="test",
                              attempts=1, retry_statuses=(), **kwargs)

    try:
        state.fence_tenant("acme", 30.0)
        resp = call("PUT", "/hints/acme/a", json=HINTS)
        assert resp.status_code == 503
        assert float(resp.headers["Retry-After"]) > 0
        assert call("GET", "/config/acme/a").status_code == 200
        # The /shard/* routes stay outside the gate.
        assert call("GET", "/shard/stream/acme").status_code == 200
        resp = call("POST", "/shard/reshard/fence/acme", json={"release": True})
        assert resp.json()["fenced"] is False
        assert call("PUT", "/hints/acme/a", json=HINTS).status_code == 200
        state.reshard_commit_source("acme", "acme:0->1@v1", 1, 2)
        for method, path in (("GET", "/config/acme/a"),
                             ("PUT", "/heartbeat/acme/a/0"),
                             ("GET", "/discover/acme/a/0")):
            resp = call(method, path, json={} if method == "PUT" else None)
            assert resp.status_code == 409
            assert resp.json() == {"error": "moved", "tenant": "acme",
                                   "shard": 1, "version": 2}
        status = call("GET", "/shard/reshard/status").json()
        assert status["shard"] == 0 and status["moved"]["acme"]["shard"] == 1
        bad = call("POST", "/shard/reshard/import/acme", json={"mode": "x"})
        assert bad.status_code == 400
    finally:
        sup.stop()


def test_migrate_tenant_between_a_jax_and_a_port_shard():
    """The port's coordinator moves a tenant from a JAX supervisor shard to
    a port one and back: the wire and the journal ops are shared."""
    shards = {}
    for sid, pkg in ((0, PACKAGES["jax"]), (1, PACKAGES["port"])):
        state = pkg.state.ClusterState(state_dir="")
        sup = pkg.supervisor.Supervisor(
            state, lease_ttl=30.0, sweep_interval=3600.0, shard_id=sid
        )
        shards[sid] = (state, sup, sup.start())
    try:
        shard_map = port_shard.ShardMap(
            {sid: entry[2] for sid, entry in shards.items()},
            overrides={"acme": 0},
        )
        _populate(shards[0][0])
        flipped = port_shard.migrate_tenant(shard_map, "acme", 0, 1, fence_s=5.0)
        assert flipped.assign("acme/a") == 1
        assert sorted(shards[1][0].jobs()) == ["acme/a", "acme/b"]
        assert shards[1][0].get_workers("acme/a") == {0: "10.0.0.1:1"}
        assert shards[0][0].moved_owner("acme")["shard"] == 1
        back = port_shard.migrate_tenant(
            port_shard.ShardMap(flipped.shards, version=flipped.version,
                                overrides={"acme": 1}),
            "acme", 1, 0, fence_s=5.0,
        )
        assert back.assign("acme/a") == 0
        assert sorted(shards[0][0].jobs()) == ["acme/a", "acme/b", "zeta/c"]
        assert shards[0][0].moved_owner("acme") is None
    finally:
        for _, sup, _ in shards.values():
            sup.stop()


def test_cli_shardmap_and_reshard_against_live_port_shards(tmp_path, capsys):
    map_path = str(tmp_path / "map.json")
    cluster = port_shard.ShardedCluster(
        2, lease_ttl=30.0, sweep_interval=3600.0, map_path=map_path
    )
    shard_map = cluster.start()
    router = port_router.Router(shard_map, map_path=map_path)
    url = router.start()
    try:
        keys = [f"tenant-{i}/job" for i in range(8)]
        for key in keys:
            cluster.create_job(key, {})
        outputs = []
        for cli in (port_cli, jax_cli):
            assert cli.main(["shardmap", "--supervisor", url,
                             "--key", keys[0]]) == 0
            outputs.append(capsys.readouterr().out)
        assert outputs[0] == outputs[1]
        assert "shard map version 1" in outputs[0]
        plans = []
        for cli, name in ((port_cli, "port"), (jax_cli, "jax")):
            plan_path = str(tmp_path / f"{name}-plan.json")
            assert cli.main(["reshard", "plan", "--supervisor", url,
                             "--retire", "1", "--out", plan_path]) == 0
            out = capsys.readouterr().out
            plans.append((out.replace(plan_path, "PLAN"), open(plan_path).read()))
        assert plans[0] == plans[1]
        plan = port_shard.ReshardPlan.load(str(tmp_path / "port-plan.json"))
        assert plan.moves and all(m["from"] == 1 for m in plan.moves)
        assert port_cli.main(["reshard", "apply", "--plan",
                              str(tmp_path / "port-plan.json"),
                              "--map", map_path, "--fence-s", "5"]) == 0
        applied = capsys.readouterr().out
        assert f"done: map v{plan.version + 1}" in applied
        router._reload_map()
        for key in keys:
            owner = router.current_map().assign(key)
            assert owner == 0
            assert cluster.shards[owner].state.get_job(key) is not None
        assert port_cli.main(["shardmap", "--supervisor", url]) == 0
        assert f"shard map version {plan.version + 1}" in capsys.readouterr().out
        statuses = []
        for cli in (port_cli, jax_cli):
            assert cli.main(["reshard", "status", "--supervisor", url]) == 0
            statuses.append(capsys.readouterr().out)
        assert statuses[0] == statuses[1]
        assert "moved" in statuses[0]
        assert port_cli.main(["reshard", "apply"]) == 2
        assert port_cli.main(["reshard", "plan"]) == 2
    finally:
        router.stop()
        cluster.stop()


def test_snapshot_import_of_a_large_tenant_over_http():
    """A snapshot-mode import of a tenant of thousands of jobs (a body of
    megabytes, past aiohttp's 1 MiB default) lands on the port's
    supervisor; a body past ``client_max_size`` is answered 413 unread."""
    src = port_state.ClusterState(state_dir="")
    for i in range(3000):
        key = f"acme/job-{i:05d}"
        src.create_job(key, {"max_replicas": 4})
        src.update(key, hints=dict(HINTS), allocation=["slot-0", "slot-1"])
    dst = port_state.ClusterState(state_dir="")
    sup = port_supervisor.Supervisor(dst, lease_ttl=30.0, sweep_interval=3600.0)
    url = sup.start()
    client = port_rpc.RpcClient()
    try:
        epoch = "acme:0->1@v1"
        batch = dict(src.stream_tenant("acme", None), epoch=epoch)
        assert len(json.dumps(batch)) > 1 << 20
        resp = client.post(f"{url}/shard/reshard/import/acme", json=batch,
                           endpoint="test", attempts=1, timeout=60)
        assert resp.status_code == 200, resp.text
        assert len(dst.jobs()) == 3000
        assert dst.export_tenant("acme")["sha"] == src.export_tenant("acme")["sha"]
        sup.client_max_size = 1 << 20
        resp = client.post(f"{url}/shard/reshard/import/acme", json=batch,
                           endpoint="test", attempts=1, retry_statuses=(),
                           timeout=60)
        assert resp.status_code == 413
        assert resp.json() == {"error": "request body too large"}
    finally:
        sup.stop()
