"""Metrics and their logging (``nf_tpu/utils/logging.py``; the reference
has no logging framework, its examples append losses to numpy arrays).

The two metrics are device functions that never read the device; the
logger runs on the host and reads a device value only when it logs it.
"""

from __future__ import annotations

import csv
import json
import os
import time

import torch


def effective_sample_size(log_weights):
    """ESS of the normalised importance weights, ``(sum w)^2 / sum w^2``,
    in log space on the weights' device (a 0-d tensor)."""
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    return torch.exp(-torch.logsumexp(2 * lw, dim=0))


def mcmc_acceptance_rate(z_before, z_after):
    """The fraction of chains that moved (a diagnostic of the MH and HMC
    layers), a float32 0-d tensor."""
    moved = torch.any((z_before != z_after).reshape(z_before.shape[0], -1),
                      dim=1)
    return torch.mean(moved.to(torch.float32))


class MetricLogger:
    """Host-side JSONL (and optionally CSV) metric logger: one record per
    :meth:`log`, with the step and the seconds since the logger opened."""

    def __init__(self, path, also_csv=False):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                    exist_ok=True)
        self._jsonl = open(path, "a")
        self._csv = None
        self._csv_writer = None
        if also_csv:
            self._csv = open(os.path.splitext(path)[0] + ".csv", "a",
                             newline="")
        self._t0 = time.time()

    def log(self, step, **metrics):
        """Write ``metrics`` (numbers or 0-d tensors, which are read here:
        the one wait for the device) at ``step``; returns the record."""
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        record.update({k: (float(v) if hasattr(v, "__float__") else v)
                       for k, v in metrics.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._csv is not None:
            if self._csv_writer is None:
                self._csv_writer = csv.DictWriter(
                    self._csv, fieldnames=list(record),
                    extrasaction="ignore", restval="")
                # a header only into a fresh file: a second header in an
                # appended file would corrupt it
                if self._csv.tell() == 0:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow(record)
            self._csv.flush()
        return record

    def close(self):
        self._jsonl.close()
        if self._csv is not None:
            self._csv.close()
