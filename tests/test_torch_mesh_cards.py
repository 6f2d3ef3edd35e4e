"""The mesh's cards (nextdenovo_tpu_torch/parallel/mesh.py): where each
shard lives, what the collectives hand each card, one host thread a card
(results in shard order, a worker's exception in the caller, spans under
their phase), and the kernels' launch counts kept exactly from many
threads (_build.count_launch).  Port only, on the CPU; groups of one device
stand for cards."""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from nextdenovo_tpu_torch import _build
from nextdenovo_tpu_torch.io.seqstore import SeqStore
from nextdenovo_tpu_torch.io.simulate import simulate_genome, simulate_reads
from nextdenovo_tpu_torch.parallel import dist_correct as tdc
from nextdenovo_tpu_torch.parallel import dist_overlap as tdo
from nextdenovo_tpu_torch.parallel import mesh as tm
from nextdenovo_tpu_torch.parallel.dist_pipeline import mesh_raw_align
from nextdenovo_tpu_torch.utils import get_tracer, span

# one intra-op thread, as in every port test
import torch_port_util  # noqa: F401

CPU = torch.device("cpu")


def _groups(n, k):
    return tm.make_mesh(n, devices=[CPU] * k)


@pytest.mark.parametrize("n,k", [(8, k) for k in range(1, 9)] +
                         [(5, 3), (7, 2), (3, 3)])
def test_placement(n, k):
    """Shard s sits in group s * k // n; the groups are contiguous blocks
    that cover every shard once, in order."""
    mesh = _groups(n, k)
    assert len(mesh.devices) == k and mesh.device == CPU
    for s in range(n):
        assert mesh.card_of(s) == s * k // n
        assert s in mesh.shards_of(mesh.card_of(s))
    assert [s for c in range(k) for s in mesh.shards_of(c)] == list(range(n))
    assert all(len(mesh.shards_of(c)) > 0 for c in range(k))


def test_make_mesh_devices():
    """An explicit device holds every shard; an explicit list is taken as
    given, one to n devices; no device means the GPU, which raises where
    there is none."""
    assert tm.make_mesh(8, "cpu").devices == (CPU,)
    assert tm.make_mesh(2, devices=["cpu", "cpu"]).devices == (CPU, CPU)
    with pytest.raises(ValueError, match="1 to 8 devices"):
        tm.make_mesh(8, devices=[CPU] * 9)
    with pytest.raises(ValueError, match="at least one shard"):
        tm.make_mesh(0, "cpu")
    if torch.cuda.is_available():
        mesh = tm.make_mesh(8)
        assert mesh.devices == tuple(
            torch.device("cuda", i)
            for i in range(min(8, torch.cuda.device_count())))
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.make_mesh(8)


def test_collectives_place_on_cards():
    """With the groups on two devices (the CPU and PyTorch's `meta`
    device), shard_rows puts each shard's block on its group's device,
    replicate gives one copy a device, and all_to_all hands destination d
    every source's bucket for d, in source order, on d's device."""
    meta = torch.device("meta")
    mesh = tm.make_mesh(4, devices=[CPU, meta])
    rows = tm.shard_rows(mesh, np.arange(16, dtype=np.int32).reshape(8, 2))
    assert [r.device for r in rows] == [CPU, CPU, meta, meta]
    assert rows[1].tolist() == [[4, 5], [6, 7]]
    assert rows[2].dtype == torch.int32 and tuple(rows[2].shape) == (2, 2)
    wide = tm.shard_rows(mesh, np.arange(8, dtype=np.uint32), torch.int64)
    assert wide[0].dtype == torch.int64 and wide[0].tolist() == [0, 1]
    rep = tm.replicate(mesh, np.arange(3))
    assert list(rep) == [CPU, meta] and rep[CPU].tolist() == [0, 1, 2]
    # the buckets start on the CPU (a meta tensor has no data to copy out)
    buckets = [[(torch.tensor([10 * s + d]), torch.tensor([s])) for d in
                range(4)] for s in range(4)]
    got = tm.all_to_all(mesh, buckets)
    for d in range(4):
        assert len(got[d]) == 4
        for s in range(4):
            assert all(f.device == mesh.device_of(d) for f in got[d][s])
            if mesh.device_of(d) == CPU:
                assert got[d][s][0].item() == 10 * s + d
                assert got[d][s][1].item() == s


def test_for_each_card_shard_order():
    """Each group runs on a thread of its own, the later groups finish
    first, and the results still come back in shard order; one group runs
    inline."""
    mesh = _groups(8, 4)
    ended, threads = [], set()

    def fn(dev, shards):
        threads.add(threading.get_ident())
        time.sleep(0.05 * (3 - mesh.card_of(shards[0])))
        ended.append(shards[0])
        return [10 * s for s in shards]

    assert mesh.for_each_card("test/order", fn) == [10 * s for s in range(8)]
    assert ended == [6, 4, 2, 0]
    assert len(threads) == 4 and threading.get_ident() not in threads
    one = _groups(8, 1)
    threads.clear()
    assert one.for_each_card("test/order", lambda d, sh: list(sh)) == \
        list(range(8))
    seen = []
    one.for_each_card("test/order",
                      lambda d, sh: seen.append(threading.get_ident())
                      or list(sh))
    assert seen == [threading.get_ident()]


def test_for_each_card_error_reaches_caller():
    """A group's exception is raised in the caller, after every other
    group has ended; no worker thread is left running, and a group that
    returns the wrong number of results fails too."""
    mesh = _groups(8, 4)
    ended = []

    def fn(dev, shards):
        card = mesh.card_of(shards[0])
        if card == 2:
            raise ValueError("card 2 failed")
        time.sleep(0.1)
        ended.append(card)
        return list(shards)

    with pytest.raises(ValueError, match="card 2 failed"):
        mesh.for_each_card("test/error", fn)
    assert sorted(ended) == [0, 1, 3]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("mesh-card") and t.is_alive()]
    with pytest.raises(RuntimeError, match="returned 1 results for 2"):
        mesh.for_each_card("test/error", lambda d, sh: [0])


def test_for_each_card_spans():
    """Spans opened on the workers land in the tracer between the start
    and the end of their phase's span, under their own names."""
    mesh = _groups(8, 2)
    tracer = get_tracer()
    n0 = len(tracer.spans)

    def fn(dev, shards):
        with span("test/spans/inner", first=shards[0]):
            time.sleep(0.02)
        return list(shards)

    mesh.for_each_card("test/spans", fn)
    new = tracer.spans[n0:]
    outer = [s for s in new if s.name == "test/spans"]
    assert len(outer) == 1 and outer[0].attrs["cards"] == 2
    o = outer[0]
    for name in ("test/spans/card", "test/spans/inner"):
        inner = [s for s in new if s.name == name]
        assert len(inner) == 2, name
        for s in inner:
            assert o.t0 <= s.t0 and s.t0 + s.wall <= o.t0 + o.wall, name
    assert {s.attrs["card"] for s in new if s.name == "test/spans/card"} \
        == {"0:cpu", "1:cpu"}


def test_count_launch_exact_from_threads(monkeypatch):
    """Eight threads counting at once, with the interpreter switching
    threads as often as it can: every launch is counted, in total and by
    card."""
    launches = dict.fromkeys(_build.LAUNCHES, 0)
    cards = {}
    monkeypatch.setattr(_build, "LAUNCHES", launches)
    monkeypatch.setattr(_build, "CARD_LAUNCHES", cards)
    n_each = 5000
    go = threading.Barrier(8)

    def count(i):
        dev = torch.device("cuda", i % 2)
        go.wait()
        for _ in range(n_each):
            _build.count_launch("myers_fwd", dev)
            _build.count_launch("vote_corridor", dev)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=count, args=(i,)) for i in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert launches["myers_fwd"] == launches["vote_corridor"] == 8 * n_each
    assert sorted(cards) == [0, 1]
    for c in cards.values():
        assert c["myers_fwd"] == c["vote_corridor"] == 4 * n_each
        assert c["chain_emit"] == 0
    _build.reset_launches()
    assert not cards and not any(launches.values())


@pytest.fixture(scope="module")
def small_store():
    g = simulate_genome(20_000, seed=5)
    sim = simulate_reads(g, coverage=16, mean_len=4000, error_rate=0.03,
                         seed=6, min_len=2500)
    store = SeqStore.from_codes(sim.reads)
    return store, np.asarray(store.length) >= 3000


def test_overlap_step_threads_out_of_order(small_store, monkeypatch):
    """raw_align over 8 shards in 4 groups whose vote/emit phase finishes
    last on the first group: the records of the one-group run."""
    store, seeds = small_store
    kw = dict(k=15, w=5, max_occ=8)
    ref = mesh_raw_align(store, seeds, _groups(8, 1), **kw)
    real = tdo._vote_emit_home

    def slow(anchors, **k):
        qid = anchors[0]
        first = int(qid.min()) if len(qid) else 0
        time.sleep(0.1 if first < len(store) // 2 else 0.0)
        return real(anchors, **k)

    monkeypatch.setattr(tdo, "_vote_emit_home", slow)
    got = mesh_raw_align(store, seeds, _groups(8, 4), **kw)
    assert len(ref) > 100
    for f in ref.data:
        assert np.array_equal(np.asarray(ref.data[f]), np.asarray(got.data[f]))


@pytest.mark.parametrize("k", (2, 4))
def test_band_align_deals_round_robin(monkeypatch, k):
    """distributed_band_align deals pair i to shard i % 8; each group makes
    one band_align call on its thread, with its shards' pairs in ascending
    order of their longer side; the results come back in input order."""
    rng = np.random.default_rng(3)
    lens = rng.integers(5, 60, 37)
    qs = [np.full(int(m), i % 4, np.int8) for i, m in enumerate(lens)]
    ts = [np.full(int(m) + i % 3, 1, np.int8) for i, m in enumerate(lens)]
    ids = {id(q): i for i, q in enumerate(qs)}
    calls = []

    def fake(qq, tt, device):
        got = [ids.get(id(q)) for q in qq]
        calls.append((threading.get_ident(), device, got))
        time.sleep(0.02 * len(calls))
        return [dict(pair=i) for i in got]

    # the pairs are int8 already: np.asarray hands band_align the same
    # objects, so each call's pairs are known by identity
    monkeypatch.setattr(tdc, "band_align", fake)
    mesh = _groups(8, k)
    res = tdc.distributed_band_align(qs, ts, mesh)
    monkeypatch.undo()
    assert [r["pair"] for r in res] == list(range(len(qs)))
    assert len(calls) == k and len({c[0] for c in calls}) == k
    for _, dev, got in calls:
        assert dev == CPU
        card = mesh.card_of(got[0] % 8)
        assert sorted(got) == [i for i in range(len(qs))
                               if mesh.card_of(i % 8) == card]
        longer = [max(len(qs[i]), len(ts[i])) for i in got]
        assert longer == sorted(longer)
