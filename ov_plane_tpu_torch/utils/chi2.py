"""Precomputed chi-squared 95% quantile table (own copy of the JAX package's).

``CHI2_095_TABLE[d]`` is the 95% quantile for d degrees of freedom; slot 0
repeats the 1-dof value so a clamped gather never reads nonsense.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import chi2 as _chi2

MAX_DOF = 1024

_table = _chi2.ppf(0.95, np.arange(1, MAX_DOF + 1))
CHI2_095_TABLE = np.concatenate([[_table[0]], _table]).astype(np.float64)
