"""Serving of the port: the queue DB, the apartment worker, the dynamic
batcher and the REST server (``aiic_tpu.serve``'s names)."""

from aiic_tpu_torch.serve.batcher import DynamicBatcher
from aiic_tpu_torch.serve.db import InMemoryDB, connect_db, seed_demo_data
from aiic_tpu_torch.serve.rest import make_server
from aiic_tpu_torch.serve.worker import ApartmentWorker, process_apartments_pipeline

__all__ = [
    "InMemoryDB",
    "connect_db",
    "seed_demo_data",
    "ApartmentWorker",
    "process_apartments_pipeline",
    "DynamicBatcher",
    "make_server",
]
