"""Configurations of the port: ``progressive_retrieval.PipelineConfig``,
the pipeline the paper deploys, and its serving profiles."""
