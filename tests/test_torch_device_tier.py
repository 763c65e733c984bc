"""The port's device embedding tier against the JAX package's, on the
CPU: the tier-policy scenarios of tests/test_device_tier.py, each run
through the port (its LocalPSClient, its K1-K3 plain versions) and
through the reference on the same batches, with the observable state
compared: hits, misses, evictions, resident ids and slots exactly (the
bookkeeping follows the id stream alone), row values within the
multi-step state tolerance of tests/test_torch_sparse.py, and the
port's own flush and writeback invariants bit for bit.

The reference's gRPC writeback round trip and its statusz telemetry
wait with the PS servicer; its pipelined ``train_stream`` is not ported,
so the stream scenario runs through ``train_step`` on both sides.
"""

import numpy as np
import pytest
import torch

from elasticdl_tpu.ps.local_client import LocalPSClient as RefLocalPSClient
from elasticdl_tpu.train import device_tier as ref_tier
from elasticdl_tpu_torch.ps.local_client import LocalPSClient
from elasticdl_tpu_torch.train import device_tier as port_tier
from tests.test_torch_sparse import (
    ADAM_EPS,
    STATE_ATOL,
    STATE_RTOL,
    VOCAB,
    make_batches,
    port_client,
    ref_client,
    tier_configs,
    trainer_pair,
)

torch.set_num_threads(1)

TABLES = ("deepfm_emb", "deepfm_linear")


def _spec(name="t", dim=4):
    return type("S", (), {"name": name, "dim": dim})()


def tier_pair(**overrides):
    """A reference and a port DeviceEmbeddingTier over one table "t"
    (dim 4) of their own LocalPSClient, numpy store seed 0."""
    ref_config, port_config = tier_configs(**overrides)
    clients = (ref_client(seed=0), port_client(seed=0))
    for client in clients:
        client.push_embedding_table_infos([("t", 4, "0.05")])
    tiers = (
        ref_tier.DeviceEmbeddingTier([_spec()], clients[0], ref_config),
        port_tier.DeviceEmbeddingTier([_spec()], clients[1], port_config,
                                      device="cpu"),
    )
    return tiers, clients


def assert_same_stats(ref, port):
    r, p = ref.stats(), port.stats()
    for key in ("hits", "misses", "evictions", "hit_rate", "occupancy"):
        assert p[key] == r[key], (key, p, r)


def assert_same_residents(ref, port, tables=TABLES, exact_rows=False):
    for table in tables:
        r_ids, r_rows = ref.table_rows(table)
        p_ids, p_rows = port.table_rows(table)
        np.testing.assert_array_equal(p_ids, r_ids, err_msg=table)
        if exact_rows:
            np.testing.assert_array_equal(p_rows, r_rows, err_msg=table)
        else:
            np.testing.assert_allclose(p_rows, r_rows, rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=table)


def eps_tier(**overrides):
    """Trainer-level tier knobs: adam at ADAM_EPS on the tier too (the
    multi-step tolerance note of tests/test_torch_sparse.py)."""
    overrides.setdefault("opt_args", {"lr": 0.01, "epsilon": ADAM_EPS})
    return tier_configs(**overrides)


def train_both(ref_t, port_t, ref_state, port_state, batches):
    for batch in batches:
        ref_state, r_loss = ref_t.train_step(ref_state, batch)
        port_state, p_loss = port_t.train_step(port_state, batch)
        np.testing.assert_allclose(float(p_loss), float(r_loss),
                                   rtol=STATE_RTOL)
    return ref_state, port_state


# ---------------------------------------------------------------------
# tier policy, tier level


def test_promotion_after_k_hits():
    """An id is promoted only after ``promote_hits`` sightings, and is
    a hit from its promotion step on; both tiers give the same slots."""
    tiers, _ = tier_pair(promote_hits=3, writeback_steps=0)
    ids = np.array([5, 9], np.int64)
    rows = np.zeros((2, 4), np.float32)
    for sighting in range(1, 4):
        got = []
        for tier in tiers:
            tier.advance()
            slots = tier.lookup("t", ids)
            assert (slots < 0).all()
            got.append(tier.admit("t", ids, rows))
        np.testing.assert_array_equal(got[1][0], got[0][0])
        np.testing.assert_array_equal(got[1][1], got[0][1])
        assert got[1][0].all() == (sighting == 3)
    for tier in tiers:
        tier.advance()
    slots = [tier.lookup("t", ids) for tier in tiers]
    assert (slots[1] >= 0).all()
    np.testing.assert_array_equal(slots[1], slots[0])
    assert tiers[1].stats()["hits"] == 2 and tiers[1].stats()["misses"] == 6
    assert_same_stats(*tiers)
    for tier in tiers:
        tier.close()


def test_lfu_pressure_evicts_coldest():
    """Promotion into a full tier evicts the least-frequently-used idle
    slot; the victim's id misses afterwards, in both tiers alike."""
    tiers, _ = tier_pair(capacity=2, promote_hits=1, writeback_steps=0,
                         ttl=0)
    rows1 = np.ones((2, 4), np.float32)
    for tier in tiers:
        tier.advance()
        tier.lookup("t", np.array([1, 2], np.int64))
        tier.admit("t", np.array([1, 2], np.int64), rows1)
        for _ in range(2):  # heat up id 1; id 2 stays cold
            tier.advance()
            assert (tier.lookup("t", np.array([1], np.int64)) >= 0).all()
        tier.advance()
        tier.lookup("t", np.array([7], np.int64))
        promoted, _ = tier.admit("t", np.array([7], np.int64), rows1[:1])
        assert promoted.all()
        tier.advance()
    slots = [tier.lookup("t", np.array([1, 2, 7], np.int64))
             for tier in tiers]
    np.testing.assert_array_equal(slots[1], slots[0])
    assert slots[1][0] >= 0, "hot id 1 must survive LFU pressure"
    assert slots[1][1] < 0, "cold id 2 must be the LFU victim"
    assert slots[1][2] >= 0
    assert tiers[1].stats()["evictions"] == 1
    assert_same_stats(*tiers)
    for tier in tiers:
        tier.close()


def test_ttl_sweep_evicts_clean_flushes_dirty_first():
    """Idle CLEAN slots evict directly; an idle DIRTY slot first forces
    a flush (becoming clean), then a later sweep evicts it."""
    tiers, clients = tier_pair(capacity=8, promote_hits=1, ttl=16,
                               writeback_steps=0)
    ids = np.array([5], np.int64)
    for tier, client in zip(tiers, clients):
        rows = client.pull_embedding_vectors("t", ids)
        tier.advance()
        tier.lookup("t", ids)
        tier.admit("t", ids, rows)
        tier.combine("t", np.full((1,), -1, np.int32),
                     np.zeros((1, 4), np.float32))  # land the insert
        for _ in range(70):
            tier.advance()
        assert tier.stats()["evictions"] == 0
        assert tier._force_flush
        tier.maybe_periodic_writeback()  # forced despite writeback 0
        tier.drain_writebacks()
        for _ in range(70):
            tier.advance()
        assert tier.stats()["evictions"] == 1
        tier.advance()
        assert (tier.lookup("t", ids) < 0).all()
    assert_same_stats(*tiers)
    np.testing.assert_array_equal(clients[1].store.lookup("t", ids),
                                  clients[0].store.lookup("t", ids))
    for tier in tiers:
        tier.close()


def test_restart_with_staged_promotions_writes_host_values():
    """A PS relaunch marked between admit (promotion staged) and
    combine (insert lands) writes the staged HOST row back, never a
    device read of the never-landed slot."""
    tiers, clients = tier_pair(capacity=8, promote_hits=1,
                               writeback_steps=0)
    ids = np.array([3, 9], np.int64)
    for tier, client in zip(tiers, clients):
        rows = client.pull_embedding_vectors("t", ids)  # materialize
        staged_rows = rows + 1.0  # the tier's values moved on
        tier.advance()
        tier.lookup("t", ids)
        promoted, _ = tier.admit("t", ids, staged_rows)
        assert promoted.all()
        tier.mark_restart()
        tier._process_restart()
        tier.drain_writebacks()
        np.testing.assert_array_equal(
            client.pull_embedding_vectors("t", ids), staged_rows)
    np.testing.assert_array_equal(clients[1].store.lookup("t", ids),
                                  clients[0].store.lookup("t", ids))
    for tier in tiers:
        tier.close()


def test_invalidate_drops_the_hot_set():
    """``invalidate`` (the resync after a flush) empties the map and the
    candidates and zeroes the device state: the ids miss again and
    promote afresh, with the same epochs and tallies as the reference."""
    tiers, clients = tier_pair(capacity=8, promote_hits=1,
                               writeback_steps=0)
    ids = np.array([3, 9], np.int64)
    for tier, client in zip(tiers, clients):
        rows = client.pull_embedding_vectors("t", ids)
        tier.advance()
        tier.lookup("t", ids)
        tier.admit("t", ids, rows)
        tier.combine("t", np.full((1,), -1, np.int32),
                     np.zeros((1, 4), np.float32))  # land the inserts
        epoch = tier.epoch
        tier.flush()
        tier.invalidate()
        assert tier.epoch == epoch + 1
        assert tier.stats()["occupancy"] == 0.0
        tier.advance()
        assert (tier.lookup("t", ids) < 0).all()
        promoted, slots = tier.admit("t", ids, rows)
        assert promoted.all()
    state = tiers[1]._tables["t"].state
    assert not any(bool(value.any()) for value in state.values())
    assert_same_stats(*tiers)
    for tier in tiers:
        tier.close()


def test_env_tier_disabled_is_none(monkeypatch):
    monkeypatch.delenv("EDL_DEVICE_TIER", raising=False)
    assert port_tier.resolve_tier_config(None) is None
    monkeypatch.setenv("EDL_DEVICE_TIER", "0")
    assert port_tier.resolve_tier_config(None) is None
    assert port_tier.resolve_tier_config(False) is None
    monkeypatch.setenv("EDL_DEVICE_TIER", "1")
    monkeypatch.setenv("EDL_DEVICE_TIER_ROWS", "123")
    monkeypatch.setenv("EDL_DEVICE_TIER_OPT_ARGS", "lr=0.5;epsilon=0.01")
    config = port_tier.resolve_tier_config(None)
    ref = ref_tier.resolve_tier_config(None)
    assert config is not None and config.capacity == 123
    for key in ("capacity", "promote_hits", "ttl", "stage_budget",
                "opt_type", "opt_args", "writeback_steps"):
        assert getattr(config, key) == getattr(ref, key), key
    assert port_tier.resolve_tier_config(True).capacity == 123
    monkeypatch.setenv("EDL_DEVICE_TIER", "maybe")
    with pytest.raises(ValueError):
        port_tier.resolve_tier_config(None)
    with pytest.raises(TypeError):
        port_tier.resolve_tier_config("on")


def test_tier_refuses_a_client_without_writeback_and_bad_optimizers():
    config = port_tier.DeviceTierConfig(capacity=4)
    with pytest.raises(ValueError, match="push_embedding_rows"):
        port_tier.DeviceEmbeddingTier([_spec()], object(), config,
                                      device="cpu")
    config = port_tier.DeviceTierConfig(capacity=4, opt_type="amsgrad")
    with pytest.raises(ValueError, match="optimizers"):
        port_tier.DeviceEmbeddingTier([_spec()], LocalPSClient(), config,
                                      device="cpu")


# ---------------------------------------------------------------------
# trainer integration


def test_ttl_demotion_writes_back():
    """Rows idle past the TTL are demoted, and a dirty victim's device
    value reaches the PS store (the eviction writeback) exactly; the
    demotions match the reference's."""
    batches = make_batches(3, seed=1)
    later = make_batches(80, seed=9, offset=VOCAB + 10)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], eps=ADAM_EPS,
        tier=eps_tier(capacity=32, promote_hits=1, ttl=10,
                      writeback_steps=0, stage_budget=16))
    ref_state, port_state = train_both(ref_t, port_t, ref_state,
                                       port_state, batches)
    tier = port_t.device_tier
    hot_ids, hot_rows = tier.table_rows("deepfm_emb")
    assert hot_ids.size > 0
    # a disjoint id range: the hot set idles past the TTL (the sweep
    # runs every 64 clocks)
    train_both(ref_t, port_t, ref_state, port_state, later)
    tier.drain_writebacks()
    ref_t.device_tier.drain_writebacks()
    assert tier.stats()["evictions"] > 0
    assert_same_stats(ref_t.device_tier, tier)
    remaining = set(tier.table_rows("deepfm_emb")[0].tolist())
    evicted = [(i, row) for i, row in zip(hot_ids, hot_rows)
               if int(i) not in remaining]
    assert evicted, "TTL sweep demoted nothing"
    store = port_t.preparer._ps.store
    ref_store = ref_t.preparer._ps.store
    for id_, row in evicted[:8]:
        got = store.lookup("deepfm_emb", np.array([id_]))[0]
        np.testing.assert_array_equal(got, row)
        np.testing.assert_allclose(
            got, ref_store.lookup("deepfm_emb", np.array([id_]))[0],
            rtol=STATE_RTOL, atol=STATE_ATOL)
    ref_t.close()
    port_t.close()


def test_never_promote_bit_exact_vs_tier_off():
    """With the tier engaged but promotion unreachable every id takes
    the pull/push path: the losses are BIT-EXACT with the tier-off
    trainer, and agree with the reference's."""
    batches = make_batches(8, seed=3)
    never = eps_tier(capacity=64, promote_hits=10 ** 9, ttl=0,
                     stage_budget=16, writeback_steps=0)
    ref_on, port_on, ref_s, port_on_s = trainer_pair(batches[0], tier=never,
                                                     eps=ADAM_EPS)
    _, port_off, _, port_off_s = trainer_pair(batches[0], eps=ADAM_EPS)
    for batch in batches:
        port_off_s, loss_off = port_off.train_step(port_off_s, batch)
        port_on_s, loss_on = port_on.train_step(port_on_s, batch)
        ref_s, ref_loss = ref_on.train_step(ref_s, batch)
        assert float(loss_off) == float(loss_on)
        np.testing.assert_allclose(float(loss_on), float(ref_loss),
                                   rtol=STATE_RTOL)
    assert port_on.device_tier.stats()["hits"] == 0
    for table in TABLES:
        a = port_off.preparer._ps.store.export_table_full(table)
        b = port_on.preparer._ps.store.export_table_full(table)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for trainer in (ref_on, port_on, port_off):
        trainer.close()


def test_flush_before_checkpoint_parity():
    """flush() (the checkpoint/export boundary) lands every tier-held
    update in the PS store: resident rows == store rows bit for bit
    (the writeback carries raw fp32), and the resident set matches the
    reference's."""
    batches = make_batches(25, seed=4)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], eps=ADAM_EPS, tier=eps_tier())
    train_both(ref_t, port_t, ref_state, port_state, batches)
    ref_t.flush_device_tier()
    port_t.flush_device_tier()
    store = port_t.preparer._ps.store
    for table in TABLES:
        ids, rows = port_t.device_tier.table_rows(table)
        assert ids.size > 0
        np.testing.assert_array_equal(rows, store.lookup(table, ids))
    assert_same_stats(ref_t.device_tier, port_t.device_tier)
    assert_same_residents(ref_t.device_tier, port_t.device_tier)
    ref_t.close()
    port_t.close()


def test_stream_flush_parity_and_hit_rate():
    """The reference's stream scenario through train_step (the
    pipelined stream is not ported): flush parity holds, and a Zipfian
    stream's warm hit rate clears 0.9 and equals the reference's."""
    batches = make_batches(40, seed=5, zipf=2.0)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], eps=ADAM_EPS, tier=eps_tier(capacity=512,
                                                 promote_hits=2))
    ref_state, port_state = train_both(ref_t, port_t, ref_state,
                                       port_state, batches)
    port_t.flush_device_tier()
    store = port_t.preparer._ps.store
    for table in TABLES:
        ids, rows = port_t.device_tier.table_rows(table)
        np.testing.assert_array_equal(rows, store.lookup(table, ids))
    # warm-phase hit rate: reset the tallies, then train more
    for tier in (ref_t.device_tier, port_t.device_tier):
        tier.hits = tier.misses = 0
    train_both(ref_t, port_t, ref_state, port_state,
               make_batches(20, seed=6, zipf=2.0))
    assert port_t.device_tier.stats()["hit_rate"] >= 0.9
    assert_same_stats(ref_t.device_tier, port_t.device_tier)
    ref_t.close()
    port_t.close()


def test_ps_restart_flush_then_invalidate():
    """A PS relaunch: the tier's rows (newer than anything the PS
    restored) are written back, then the map invalidates and
    repopulates, with the same epochs, hits and residents as the
    reference."""
    batches = make_batches(16, seed=7)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], eps=ADAM_EPS,
        tier=eps_tier(capacity=256, promote_hits=1, writeback_steps=0))
    ref_state, port_state = train_both(ref_t, port_t, ref_state,
                                       port_state, batches[:8])
    tier = port_t.device_tier
    pre_ids, pre_rows = tier.table_rows("deepfm_emb")
    assert pre_ids.size > 0
    store = port_t.preparer._ps.store
    stale = store.lookup("deepfm_emb", pre_ids)
    assert not np.allclose(stale, pre_rows)  # the store lags the tier
    epoch0 = tier.epoch
    for trainer in (ref_t, port_t):
        trainer.preparer._on_ps_restart(0)
    assert tier.epoch == epoch0 + 1 == ref_t.device_tier.epoch
    # the host maps are invalid at once
    assert (tier.lookup("deepfm_emb", pre_ids) < 0).all()
    ref_t.device_tier.lookup("deepfm_emb", pre_ids)  # same tallies
    train_both(ref_t, port_t, ref_state, port_state, batches[8:])
    tier.drain_writebacks()
    post = store.lookup("deepfm_emb", pre_ids)
    # every pre-restart resident row's latest value reached the store
    # (later steps may have moved it again; none regressed to stale)
    for k in range(pre_ids.size):
        assert not np.allclose(post[k], stale[k]) or np.allclose(
            pre_rows[k], stale[k]), int(pre_ids[k])
    assert_same_stats(ref_t.device_tier, tier)
    assert_same_residents(ref_t.device_tier, tier)
    ref_t.close()
    port_t.close()


def test_stale_step_context_reprepares():
    """A batch prepared before a PS relaunch is not combined with its
    stale slot context: the trainer re-prepares it, on both sides
    alike."""
    batches = make_batches(6, seed=8)
    ref_t, port_t, ref_state, port_state = trainer_pair(
        batches[0], eps=ADAM_EPS,
        tier=eps_tier(capacity=128, promote_hits=1, writeback_steps=0))
    ref_state, port_state = train_both(ref_t, port_t, ref_state,
                                       port_state, batches[:4])
    for trainer in (ref_t, port_t):
        _, pull_info = trainer.preparer.prepare(batches[4])
        trainer.preparer._on_ps_restart(0)
        assert pull_info.tier_epoch != trainer.device_tier.epoch
    ref_state, port_state = train_both(ref_t, port_t, ref_state,
                                       port_state, batches[5:])
    assert_same_stats(ref_t.device_tier, port_t.device_tier)
    ref_t.close()
    port_t.close()


def test_tier_kernels_on_the_cpu_count_no_launch():
    """On the CPU the tier runs K1-K3's plain versions: a tier-on step
    moves no launch counter (on the card each moves; see
    tests/test_torch_cuda_kernels.py)."""
    from elasticdl_tpu_torch.ops import embedding_tier as tier_ops

    batches = make_batches(3, seed=2)
    _, port_t, _, state = trainer_pair(batches[0], tier=eps_tier())
    before = (tier_ops.GATHER_LAUNCHES, tier_ops.SET_ROWS_LAUNCHES,
              tier_ops.SCATTER_APPLY_LAUNCHES)
    for batch in batches:
        state, loss = port_t.train_step(state, batch)
    assert (tier_ops.GATHER_LAUNCHES, tier_ops.SET_ROWS_LAUNCHES,
            tier_ops.SCATTER_APPLY_LAUNCHES) == before
    stats = port_t.device_tier.stats()
    # every step combined each table once: gather-only or staged
    assert stats["gather_only_combines"] + stats["staged_chunks"] >= 6
    assert port_t.device_tier.device == torch.device("cpu")
    port_t.close()


def test_ref_local_client_is_numpy():
    """The reference side of every comparison above runs the numpy
    store (the native store's lazy init is another random stream)."""
    from elasticdl_tpu.ps.embedding_store import NumpyEmbeddingStore

    assert isinstance(ref_client().store, NumpyEmbeddingStore)
    assert isinstance(ref_client(), RefLocalPSClient)
