from . import configure, log, wire_codec  # noqa: F401
from .dashboard import Dashboard, Monitor, monitor, trace_to  # noqa: F401
from .mt_queue import MtQueue  # noqa: F401
from .quantization import OneBitFilter, SparseFilter  # noqa: F401
from .timer import Timer  # noqa: F401
from .waiter import Waiter  # noqa: F401
