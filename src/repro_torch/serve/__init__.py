from .cache import (AllocatorInvariantError, BlockAllocator,
                    BlockTransferBuffer, CacheConfig, CacheError,
                    CacheExhausted, CacheLayout, PagedKVStore)
from .engine import (PREFILL_BUCKET_FLOOR, ContinuousEngine, Engine,
                     bucket_length, make_bucketed_prefill_step,
                     make_chunk_prefill_step, make_draft_decode_step,
                     make_paged_decode_step, make_prefill_step,
                     make_serve_step, make_verify_step)
from .router import (FleetAdaptation, Replica, RequestMigration,
                     RouteDecision, RoutedRequest, Router)
from .sampling import GREEDY, SamplingParams
from .scheduler import ActiveSlot, Request, SlotScheduler
