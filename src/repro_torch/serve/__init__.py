from .cache import (AllocatorInvariantError, BlockAllocator, CacheConfig,
                    CacheError, CacheExhausted, PagedKVStore)
from .engine import (ContinuousEngine, Engine, make_paged_decode_step,
                     make_prefill_step, make_serve_step)
from .scheduler import ActiveSlot, Request, SlotScheduler
