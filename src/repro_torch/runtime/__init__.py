from .telemetry import FleetTelemetry, ServeStep, ServeTelemetry, Telemetry
from .elastic import ElasticController
