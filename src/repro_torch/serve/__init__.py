from repro_torch.serve.engine import EngineUndrained, Request, ServeEngine
from repro_torch.serve.snn_engine import (ReportUnavailable, SNNRequest,
                                          SNNServeEngine)

__all__ = ["EngineUndrained", "ReportUnavailable", "Request", "ServeEngine",
           "SNNRequest", "SNNServeEngine"]
