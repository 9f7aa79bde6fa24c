"""NCO op class (port of ``tpudsp/ops/nco_op.py``): not ported yet;
building one raises NotImplementedError naming its ROADMAP.md item."""

from .base import not_ported

NCO = not_ported("NCO", "Queue A #7")
