"""Identity and value types, DER parsing, and the packed batch schema
(copies of ``ct_mapreduce_tpu.core``)."""
