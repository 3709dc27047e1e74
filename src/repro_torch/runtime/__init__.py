from .telemetry import ServeStep, ServeTelemetry, Telemetry
from .elastic import ElasticController
