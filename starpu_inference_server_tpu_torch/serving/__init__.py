"""Serving: the decoder generation engine, and the batch pipeline
(bounded queue -> batch collector with three strategies -> lane
scheduler -> execution lanes -> result dispatcher), counterpart of
``starpu_inference_server_tpu/serving``."""
