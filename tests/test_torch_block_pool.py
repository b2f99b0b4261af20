"""The port's ``BlockPool`` and ``PrefixCache`` against the JAX package's,
driven by the same sequence of operations, and the port's counterparts of
the allocator cases of tests/test_paged_attention.py."""

import numpy as np
import pytest

from pipelinerl_tpu.inference import block_pool as jbp
from pipelinerl_tpu_torch.inference import block_pool as tbp


def drive(mod) -> list:
    """Allocate, extend, fork, register, release, lookup, attach, evict: the
    state after every operation (tables, refs, free list, cache entries)."""
    pool = mod.BlockPool(n_blocks=14, block_size=4, max_blocks_per_slot=5, n_slots=4)
    cache = mod.PrefixCache(pool, max_pages=5)
    rng = np.random.default_rng(0)
    a = rng.integers(1, 100, 30).tolist()
    b = rng.integers(1, 100, 30).tolist()
    states = []

    def snap(result=None):
        states.append((
            pool.table.tolist(), pool.refs.tolist(), list(pool._free), pool.slot_blocks.tolist(),
            cache.hits, cache.reused_tokens, cache.pages_held, [(k[0], v.tolist()) for k, v in cache._entries.items()],
            result,
        ))
        pool.check_invariants()

    snap(pool.allocate(0, 10).tolist())
    snap(pool.extend(0, 14).tolist())
    snap(pool.extend(0, 15).tolist())  # within the last page: nothing new
    tail, shared = pool.fork(0, 1, 10)
    snap((tail.tolist(), shared))
    tail, shared = pool.fork(0, 2, 8)  # on a page boundary: no tail to copy
    snap((tail.tolist(), shared))
    cache.register(a[:14], pool.table[0])
    snap()
    pool.release(0)
    snap()
    hit = cache.lookup(a[:13] + [7, 7])
    snap((hit[0].tolist(), hit[1]))
    snap(cache.lookup(b[:12]))  # a miss
    pool.release(1)
    pool.attach(0, hit[0])
    snap(pool.extend(0, 20).tolist())
    cache.register(b[:21], pool.table[0])  # over max_pages: the LRU entry goes
    snap()
    pool.release(2)
    snap(cache.evict_for(pool.free_blocks + 1))
    with pytest.raises(mod.OutOfBlocks):
        pool.allocate(3, 21)  # more pages than a slot may hold
    with pytest.raises(mod.OutOfBlocks):
        pool.allocate(3, 4 * 20)
    pool.release(0)
    snap(cache.evict_for(pool.n_blocks))
    return states


def test_block_pool_and_prefix_cache_match_jax():
    assert drive(tbp) == drive(jbp)


def test_block_pool_fork_and_release():
    pool = tbp.BlockPool(n_blocks=10, block_size=8, max_blocks_per_slot=4, n_slots=4)
    pool.allocate(0, 20)  # 3 pages (2 full + partial)
    free_before = pool.free_blocks
    tail, shared_tokens = pool.fork(0, 1, 20)
    assert shared_tokens == 16 and tail.size == 1
    assert pool.free_blocks == free_before - 1
    assert pool.refs[pool.table[0, 0]] == 2
    assert pool.refs[pool.table[0, 2]] == 1  # the source's partial tail is not shared
    assert pool.refs[tail[0]] == 1
    pool.check_invariants()
    pool.release(0)  # shared pages survive for the fork
    assert pool.refs[pool.table[1, 0]] == 1
    pool.check_invariants()
    pool.release(1)
    assert pool.free_blocks == 10
    pool.check_invariants()


def test_block_pool_exact_boundary_fork():
    pool = tbp.BlockPool(n_blocks=6, block_size=8, max_blocks_per_slot=3, n_slots=3)
    pool.allocate(0, 16)  # exactly 2 full pages
    tail, shared = pool.fork(0, 1, 16)
    assert shared == 16 and tail.size == 0  # nothing to copy
    pool.check_invariants()


def test_block_pool_oom_and_reuse():
    pool = tbp.BlockPool(n_blocks=4, block_size=8, max_blocks_per_slot=4, n_slots=4)
    pool.allocate(0, 24)  # 3 pages
    assert not pool.can_allocate(16)
    with pytest.raises(tbp.OutOfBlocks):
        pool.allocate(1, 16)
    pool.release(0)
    assert pool.can_allocate(32)
    pool.allocate(1, 32)
    with pytest.raises(tbp.OutOfBlocks):
        pool.extend(1, 33)  # exceeds max pages per slot
    pool.check_invariants()


def test_extend_within_page_allocates_nothing():
    pool = tbp.BlockPool(n_blocks=4, block_size=8, max_blocks_per_slot=4, n_slots=2)
    pool.allocate(0, 3)
    assert pool.extend(0, 7).size == 0  # same page
    assert pool.extend(0, 9).size == 1  # crosses into a second page
    pool.check_invariants()
