from repro_torch.serve.engine import Engine
from repro_torch.serve.kv_cache import (KVQuantSpec, PageAllocator,
                                        init_kv_pools)
from repro_torch.serve.scheduler import Request, Scheduler, ServeConfig

__all__ = ["Engine", "ServeConfig", "Scheduler", "Request", "KVQuantSpec",
           "PageAllocator", "init_kv_pools"]
