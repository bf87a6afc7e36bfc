"""Serving in the PyTorch port: the LM prefill/decode loop
(`repro_torch.serve.lm_engine`).  The JAX package's multi-tenant
interface-fabric serving tier (`repro.serve.engine` and its admission,
health, queue and tenant modules) is not ported: ROADMAP queue A
item 10."""
