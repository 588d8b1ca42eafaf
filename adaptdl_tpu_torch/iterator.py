"""BPTT-style language-model iteration, the port of ``adaptdl_tpu.iterator``.

A flat token corpus is viewed as a dataset of (input, target) windows,
and the ordinary :class:`~adaptdl_tpu_torch.data.AdaptiveDataLoader`
supplies the partitioning, mid-epoch resume at any replica count,
adaptive batch sizing and whole batches (``drop_last``): the component
reduces to the windowing view plus a constructor.
"""

from __future__ import annotations

import numpy as np

from adaptdl_tpu_torch.data import AdaptiveDataLoader


class TokenWindowDataset:
    """View a flat token array as BPTT windows.

    Window ``i`` covers tokens ``[i*bptt, i*bptt + bptt]`` (one extra
    token so inputs and targets are aligned shifts). Samples are dicts
    ``{"inputs": [bptt], "targets": [bptt]}`` of int32.
    """

    def __init__(self, tokens: np.ndarray, bptt: int):
        tokens = np.asarray(tokens)
        if tokens.ndim != 1:
            raise ValueError("corpus must be a flat 1-D token array")
        self.tokens = tokens
        self.bptt = bptt
        self._num_windows = max((len(tokens) - 1) // bptt, 0)

    def __len__(self) -> int:
        return self._num_windows

    def __getitem__(self, index: int) -> dict:
        start = index * self.bptt
        window = self.tokens[start : start + self.bptt + 1]
        return {
            "inputs": window[:-1].astype(np.int32),
            "targets": window[1:].astype(np.int32),
        }


def AdaptiveBPTTLoader(
    tokens: np.ndarray,
    batch_size: int,
    bptt: int,
    shuffle: bool = True,
    **kwargs,
) -> AdaptiveDataLoader:
    """Elastic BPTT loader over a flat corpus; ``kwargs`` go to the
    loader (``drop_last``, ``seed``, ``name``)."""
    return AdaptiveDataLoader(
        TokenWindowDataset(tokens, bptt),
        batch_size=batch_size,
        shuffle=shuffle,
        **kwargs,
    )
