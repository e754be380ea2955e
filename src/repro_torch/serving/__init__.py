"""Serving: the continuous-batching engine, its decode backends, the
multi-model router and the HTTP/SSE front end (port of
``repro.serving``)."""

from repro_torch.models.registry import CapabilityFallbackWarning
from repro_torch.serving.backends import (BACKENDS, DecodeBackend,
                                          PagedBackend, SlotBackend,
                                          SpecDecodeBackend, make_backend)
from repro_torch.serving.engine import InferenceEngine, pow2_buckets
from repro_torch.serving.multi import MultiModelServer
from repro_torch.serving.paging import (BlockPool, blocks_for_rows,
                                        default_n_blocks)
from repro_torch.serving.queue import KVBudget, PagedKVBudget, RequestQueue
from repro_torch.serving.request import Request, Status
from repro_torch.serving.server import (HydraHTTPServer, ServingFrontend,
                                        encode_prompt)
from repro_torch.serving.slo import (PRIORITIES, SLO, FIFOPolicy,
                                     OverloadedError, SLOPolicy, make_policy)
from repro_torch.serving.slots import SlotPool, stack_trees, write_slots
from repro_torch.serving.stream import TokenStream

__all__ = ["InferenceEngine", "MultiModelServer", "KVBudget", "PagedKVBudget",
           "RequestQueue", "Request", "Status", "SlotPool", "BlockPool",
           "blocks_for_rows", "default_n_blocks", "stack_trees",
           "write_slots", "pow2_buckets", "DecodeBackend", "SlotBackend",
           "PagedBackend", "SpecDecodeBackend", "BACKENDS", "make_backend",
           "CapabilityFallbackWarning", "TokenStream", "SLO", "SLOPolicy",
           "FIFOPolicy", "OverloadedError", "PRIORITIES", "make_policy",
           "ServingFrontend", "HydraHTTPServer", "encode_prompt"]
