"""Train state tree."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..optim.adamw import AdamWState
from ..tree import tree_map


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor          # 0-dim int32 on the host


def init_state(params, optimizer) -> TrainState:
    """Step 0 of ``params`` under ``optimizer``. The state holds
    ``params``' tensors themselves, detached (the engines serve
    ``state.params`` as they are), and the train step writes them in
    place: pass copies to keep the originals."""
    params = tree_map(lambda p: p.detach(), params)
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32))
