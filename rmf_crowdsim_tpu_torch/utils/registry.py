"""Monotonic-id registry, mirroring the reference's ``Registry<T>``
(util/registry.rs:3-22): ``add_new_item`` returns a fresh id; the backing
dict is public, and entries can be removed by id.

A copy of ``rmf_crowdsim_tpu/utils/registry.py``, which has no JAX in it
but cannot be imported without the JAX package's ``__init__``."""

from __future__ import annotations

from typing import Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self) -> None:
        self.registry: Dict[int, T] = {}
        self._next_id = 0

    def add_new_item(self, item: T) -> int:
        item_id = self._next_id
        self._next_id += 1
        self.registry[item_id] = item
        return item_id

    def remove(self, item_id: int) -> None:
        self.registry.pop(item_id, None)

    def __len__(self) -> int:
        return len(self.registry)

    def values(self):
        return self.registry.values()

    def items(self):
        return self.registry.items()
