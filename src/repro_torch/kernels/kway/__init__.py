"""K-way splitter classifier of the external lane: the Hopper kernel
(csrc/kway.cu), its plain version (ref.py) and the wrapper
``kway_classify`` (ops.py)."""
from .ops import LAUNCHES, kway_classify  # noqa: F401
from .ref import kway_classify_ref  # noqa: F401
