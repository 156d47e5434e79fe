"""repro_torch.runtime — the runtime of the port (counterpart of
``repro/runtime``), plain Python and numpy: the restart loop, the
straggler watchdog and the fault policy (``failures.py``); atomic async
checkpoints in the reference's layout (``checkpoint.py``); and the
rescale plans of a training mesh and of a sorting mesh, with the restore
of a training state onto one device or onto a mesh, each rank keeping
its slices (``elastic.py``)."""
from .checkpoint import CheckpointManager  # noqa: F401
from .elastic import (RescalePlan, SortRescalePlan,  # noqa: F401
                      plan_rescale, plan_sort_rescale, rescale_state)
from .failures import (FaultPolicy, StepWatchdog,  # noqa: F401
                       flag_stragglers, run_with_restarts)
