from .pipeline import DataConfig, Prefetcher, SyntheticLM, make_pipeline
