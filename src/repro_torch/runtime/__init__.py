from .telemetry import ServeStep, ServeTelemetry
