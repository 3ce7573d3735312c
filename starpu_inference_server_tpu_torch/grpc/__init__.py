"""KServe-v2 gRPC front door of the port (decoder generation subset)."""
