"""Core runtime of the batch pipeline: jobs, timing, staging slots and
the model engine (counterpart of ``starpu_inference_server_tpu/core``).
The engine runs the model eagerly on one device; batches are padded to
a fixed bucket set, each bucket run once at warmup (``prime``)."""
