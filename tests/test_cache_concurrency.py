"""Threaded stress tests for the LRU cache (SURVEY.md §5.2: the host
cache is the one conventionally-locked component; the reference relies
on Cache.ipp's per-entry locking discipline — concurrent loads of the
SAME id must construct once, different ids proceed in parallel,
eviction never drops pinned entries)."""

import threading
import time

import pytest

from libre.core.cache import CacheLoadError, LRUCache


def test_same_id_constructs_once_under_contention():
    calls = []
    lock = threading.Lock()

    def loader(cache_id):
        with lock:
            calls.append(cache_id)
        time.sleep(0.01)  # widen the race window
        return ("value", cache_id), 64

    cache = LRUCache("t", max_bytes=1 << 20, loader=loader)
    results = [None] * 16
    barrier = threading.Barrier(16)

    def worker(i):
        barrier.wait()
        results[i] = cache.load(7)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == [7]  # constructed exactly once (Cache.ipp:98-119)
    assert all(r.value == ("value", 7) for r in results)
    assert cache.statistics.hits == 15 and cache.statistics.misses == 1


def test_distinct_ids_load_in_parallel():
    """Loads of different ids must not serialize behind one entry lock."""
    started = threading.Barrier(4, timeout=5)

    def loader(cache_id):
        started.wait()  # deadlocks (Barrier timeout) if loads serialize
        return cache_id, 64

    cache = LRUCache("t", max_bytes=1 << 20, loader=loader)
    errs = []

    def worker(i):
        try:
            cache.load(i)
        except threading.BrokenBarrierError as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs and len(cache) == 4


def test_eviction_never_drops_pinned_under_churn():
    """Hammer a tiny cache from many threads while holding pins; pinned
    entries must survive every eviction pass (LRUCachePolicy semantics,
    Cache.ipp:27-85)."""
    cache = LRUCache("t", max_bytes=8 * 64, loader=lambda i: (i, 64))
    pinned = [cache.load(i).pin() for i in range(4)]
    stop = threading.Event()
    errs = []

    def churn(seed):
        i = seed
        while not stop.is_set():
            i = (i * 1103515245 + 12345) % 1000 + 100
            try:
                e = cache.load(i)
                assert e.value == i
            except CacheLoadError:
                pass
            except Exception as e:  # pragma: no cover
                errs.append(e)
                return

    threads = [threading.Thread(target=churn, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join()
    assert not errs
    for i, e in enumerate(pinned):
        got = cache.get(i)
        assert got is not None and got.value == i, f"pinned {i} evicted"
        e.unpin()
    assert cache.statistics.used_bytes <= cache.statistics.max_bytes + 64


def test_failed_load_erased_and_retryable():
    """Construction failure ⇒ CacheLoadError and the entry is erased so
    a later load retries (Cache.ipp:110-113,191-192)."""
    attempts = []

    def loader(cache_id):
        attempts.append(cache_id)
        if len(attempts) == 1:
            raise RuntimeError("disk hiccup")
        return cache_id, 64

    cache = LRUCache("t", max_bytes=1 << 20, loader=loader)
    with pytest.raises(CacheLoadError):
        cache.load(3)
    assert 3 not in cache
    assert cache.load(3).value == 3
    assert attempts == [3, 3]
