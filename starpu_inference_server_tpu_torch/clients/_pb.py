"""Re-export of the port's generated protocol module for client code."""

from ..grpc.kserve_v2_pb2 import *  # noqa: F401,F403
from ..grpc.kserve_v2_pb2 import (  # noqa: F401
    ModelInferRequest,
    ModelInferResponse,
    ModelStreamInferResponse,
    ServerLiveRequest,
    ServerLiveResponse,
    ServerReadyRequest,
    ServerReadyResponse,
)
