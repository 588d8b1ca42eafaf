"""Parallel modes of the port: the process mesh (:mod:`.mesh`), the
sequence axis's attention (:mod:`.ulysses`, :mod:`.ring_attention`),
Megatron tensor parallelism over the model axis (:mod:`.tensor_parallel`),
the pipeline schedules over the stage axis (:mod:`.pipeline`) and
per-layer ZeRO-3 (:mod:`.zero3`)."""
