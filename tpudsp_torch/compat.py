"""Drop-in stand-in for the reference's ``liquiddsp`` extension module, on
PyTorch and the card:

    import tpudsp_torch.compat as liquiddsp

exposes the 29 classes + bytes_to_iq of ``tpudsp.compat``, with the same
names, kwargs and defaults.
"""

from .ops import *  # noqa: F401,F403
from .ops import __all__  # noqa: F401
