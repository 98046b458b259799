"""The port's in-process runtime (copies of ray_tpu/core/: ids, task specs,
object refs, resources, the local runtime, placement groups, the runtime
context) and core/channel.py, the LLM feed's transport."""
