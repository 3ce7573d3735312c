"""Clients: the schedule-replay load generator with its summary JSON
(``client.py``), the generation client that measures time to first
token, and the BERT client (``bert_client.py``).

Counterpart of ``starpu_inference_server_tpu/clients``. They speak the
KServe-v2 protocol only, so each drives a server of either package.
Run them as ``python -m starpu_inference_server_tpu_torch.clients.client``
and ``python -m starpu_inference_server_tpu_torch.clients.bert_client``.
"""
