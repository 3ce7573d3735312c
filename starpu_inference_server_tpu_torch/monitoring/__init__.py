"""Observability: Prometheus metrics, congestion detection, batching
traces (counterpart of ``starpu_inference_server_tpu/monitoring``).
Host code only: the device families read the CUDA caching allocator."""
