"""Signature verification: the auditing workload (a port of
``ct_mapreduce_tpu.verify``).

- :mod:`ct_mapreduce_tpu_torch.verify.host` — the pure-python reference
  verifier (generic short-Weierstrass ECDSA + RSA PKCS#1 v1.5): the
  ground truth every device verdict equals, and the host lane for
  signatures the device does not decide.
- :mod:`ct_mapreduce_tpu_torch.verify.sct` — the embedded-SCT wire
  format: extension scan, TLS SCT-list parsing, the RFC 6962 signed
  payload, fixture signers, and DER surgery to embed SCTs into any
  certificate.
- :mod:`ct_mapreduce_tpu_torch.verify.lane` — the ingest-side
  verification lane: log-key registry, device-batch staging with
  asynchronous dispatch (K6 on the card), host replay, per-issuer
  verified/failed fold into the aggregator.
"""
