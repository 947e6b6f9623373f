"""Evaluation metrics (``nf_tpu/utils/eval.py``; reference
``normflows/utils/eval.py``)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .nn import sum_except_batch


def bits_per_dim(model, x, y=None, trans="logit", trans_param=(0.05,)):
    """Bits per dimension of a batch under ``model``, with the logit
    dequantisation's correction (reference ``eval.py:5-34``): ``x`` is
    the model's input (logits), ``y`` the labels of a class-conditional
    model."""
    if trans != "logit":
        raise NotImplementedError(
            f"The transformation {trans} is not implemented.")
    dims = math.prod(x.shape[1:])
    log_q = model.log_prob(x) if y is None else model.log_prob(x, y)
    sig_ = sum_except_batch(F.logsigmoid(x)) / math.log(2)
    sig_ = sig_ + sum_except_batch(F.logsigmoid(-x)) / math.log(2)
    b = -log_q / dims / math.log(2) - math.log2(1 - trans_param[0]) + 8
    return b + sig_ / dims


def bits_per_dim_dataset(model, data_iter, class_cond=True, trans="logit",
                         trans_param=(0.05,)):
    """The mean bits per dimension over an iterable of ``(x, y)`` batches,
    NaN rows left out (reference ``eval.py:37-63``)."""
    n = 0
    b_cum = 0.0
    with torch.no_grad():
        for x, y in data_iter:
            b_np = bits_per_dim(model, x, y if class_cond else None, trans,
                                trans_param).cpu().numpy()
            b_cum += np.nansum(b_np)
            n += len(b_np) - int(np.sum(np.isnan(b_np)))
    return b_cum / n


# the reference's names
bitsPerDim = bits_per_dim
bitsPerDimDataset = bits_per_dim_dataset
