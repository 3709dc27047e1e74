from .telemetry import ServeStep, ServeTelemetry
from .elastic import ElasticController
