"""Serving layer of the port: the VPC NT chain (``vpc``), the LLM serving
engine (``engine``) and the disaggregated KV store case study
(``kv_store``, host Python on the event simulator)."""
