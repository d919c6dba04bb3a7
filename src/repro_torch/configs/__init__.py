"""Model configs of the port: copies of ``repro/configs`` for the
families the port runs (dense and vlm), and the registry."""
