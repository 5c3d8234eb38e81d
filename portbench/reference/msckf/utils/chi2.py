"""Chi-squared gating table (port of ``msckf_mono_tpu/utils/chi2.py``).

The reference builds a 0.05-quantile chi-squared table at initialize time
(msckf.h:89-95) and indexes it as ``chi_squared_test_table[dof + 1]`` in the
gating test (msckf.h:1117). Because ``table[i-1] = quantile(chi2(i), 0.05)``,
that lookup evaluates the quantile at ``dof + 2`` degrees of freedom — an
off-by-one quirk of the reference, exposed here as a flag.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from scipy.stats import chi2 as _chi2

MAX_DOF = 256

# _TABLE[k] = 0.05-quantile of a chi2 with k dof; k=0 entry is a placeholder.
_TABLE = np.concatenate([[0.0], _chi2.ppf(0.05, np.arange(1, MAX_DOF + 1))]).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _table_on(dtype, device):
    return torch.as_tensor(_TABLE, dtype=dtype, device=device)


def chi2_gate_table(dtype=torch.float32, device=None):
    """The quantile table as a tensor, indexable by degrees of freedom.

    Cached per (dtype, device), so the filter step copies it to the card once.
    Treat it as read-only.
    """
    return _table_on(dtype, torch.device(device) if device is not None else torch.device("cpu"))


def gate_threshold(dof, *, reproduce_offbyone: bool = True, dtype=torch.float32, device=None):
    """Gating threshold for the Mahalanobis test.

    With ``reproduce_offbyone`` (default) this matches the reference's
    ``table[dof+1]`` lookup, i.e. the 0.05 quantile at ``dof+2`` dof.
    ``dof`` is a Python int or an integer tensor (then clipped to the table).
    """
    if isinstance(dof, torch.Tensor):
        device = dof.device
    table = chi2_gate_table(dtype, device)
    idx = dof + 2 if reproduce_offbyone is True else dof
    if isinstance(idx, torch.Tensor):
        idx = torch.clamp(idx, 1, MAX_DOF).long()
    return table[idx]
