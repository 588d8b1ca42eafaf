"""The Pollux policy: job and node descriptors, the speedup function and
the genetic search over allocations (the port's copy of
``adaptdl_tpu.sched.policy``)."""

from adaptdl_tpu_torch.sched.policy.pollux import PolluxPolicy  # noqa: F401
from adaptdl_tpu_torch.sched.policy.speedup import SpeedupFunction  # noqa: F401
from adaptdl_tpu_torch.sched.policy.utils import JobInfo, NodeInfo  # noqa: F401
