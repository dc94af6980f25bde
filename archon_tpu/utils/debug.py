"""Debug/poison-mode utilities (SURVEY.md section 5: race detection analog).

The reference's debug machinery is assert density plus memory poisoning
(a5's kDebug=DM_CHECK memsets unused group regions to -1 so a wrong
derivation trips immediately, a5/src/archon.c:155-160).  The JAX analogs:

- ``checked(fn)``: wrap a jitted function with jax.experimental.checkify to
  surface index/NaN errors that silent clamping would hide;
- ``poison_check(rank)``: assert no poison values survived a refinement
  (the -1 fill convention used by the narrowed path's pads).
"""

from __future__ import annotations

import numpy as np


def checked(fn):
    """checkify-wrap: returns (err, out); err.throw() raises on failure."""
    from jax.experimental import checkify

    return checkify.checkify(fn, errors=checkify.index_checks | checkify.float_checks)


def poison_check(arr, poison=-1, name="array") -> None:
    """Host-side poison assertion (a5 DM_CHECK analog)."""
    a = np.asarray(arr)
    bad = int((a == poison).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} poison value(s) survived")
