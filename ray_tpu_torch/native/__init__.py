"""The port's native components (copy of ray_tpu/native/): the shared-memory
object pool, built with g++ at first use."""
