"""The job side of the scheduler: the preemption-notice listener and the
urgent drain (``preemption``)."""
