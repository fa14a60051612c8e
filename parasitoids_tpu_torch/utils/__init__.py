"""Host-side helpers of the port (copies of ``parasitoids_tpu/utils``:
``checks``, ``durable``)."""
