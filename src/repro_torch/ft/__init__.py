"""``repro_torch.ft`` — the fault-tolerance plane of the port: seeded
fault injection at named sites (:mod:`.faults`) and the heartbeat /
elastic re-mesh supervisor (:mod:`.supervisor`), host code both."""
from . import faults  # noqa: F401
from .faults import FaultInjector, FaultSpec  # noqa: F401
from .supervisor import Supervisor, HeartbeatMonitor, ElasticPlan  # noqa: F401
