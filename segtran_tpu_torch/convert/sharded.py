"""A full state_dict to one rank's share of a sharded training state and
back (``parallel/tensor_parallel.py``): pure tensor slicing, no
collectives, so a checkpoint can be split or joined offline.

``spec`` maps each name to ``Shard(dim)`` or ``Replicate()``
(``tensor_parallel.state_sharding_spec``); a sharded tensor is cut into
``count`` equal contiguous blocks along ``dim``, block ``index`` being
rank ``index``'s of the ``model`` group.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch.distributed.tensor import Shard


def shard_slice(t: torch.Tensor, dim: int, index: int, count: int
                ) -> torch.Tensor:
    """Block ``index`` of ``count`` along ``dim`` (a view)."""
    size = t.shape[dim]
    if size % count:
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{count} blocks")
    per = size // count
    return t.narrow(dim, index * per, per)


def state_dict_to_sharded(sd: Dict[str, torch.Tensor], spec, index: int,
                          count: int) -> Dict[str, torch.Tensor]:
    """Rank ``index``'s share: sharded tensors cut, the rest whole."""
    return {k: (shard_slice(v, spec[k].dim, index, count).clone()
                if isinstance(spec.get(k), Shard) else v)
            for k, v in sd.items()}


def state_dict_from_sharded(shards: Sequence[Dict[str, torch.Tensor]],
                            spec) -> Dict[str, torch.Tensor]:
    """The full state_dict from every rank's share, in rank order."""
    first = shards[0]
    return {k: (torch.cat([s[k] for s in shards], spec[k].dim)
                if isinstance(spec.get(k), Shard) else v)
            for k, v in first.items()}
