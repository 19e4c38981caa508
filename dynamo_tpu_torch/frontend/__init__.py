"""The port's OpenAI frontend, copied from dynamo_tpu/frontend/:
`service.py` (HttpService on runtime/http_server.py, ModelManager,
ModelWatcher with the prefill, encoder and decode roles),
`pipeline.py` (the encoder and prefill hops, migration,
detokenization, stop strings), `preprocessor.py` (chat templates on
jinja2), `parsers.py`, `request_trace.py`, `affinity.py` (session
headers, the AffinityCoordinator and SessionAffinityRouter),
`anthropic.py` (/v1/messages), `openai_extra.py` (Responses, Files,
Batches) and `tokenizer.py`, which the worker's guided decoding also
uses, and `kserve.py` (the KServe v2 gRPC service, `--grpc-port`, over
`kserve_pb2.py`, a byte-identical copy of the JAX package's).  Run it
with `python -m dynamo_tpu_torch.frontend`.  The modules are imported
where they are used, so a worker that needs only the tokenizer loads
no HTTP code."""
