"""The port's OpenAI frontend, copied from dynamo_tpu/frontend/ for the
aggregated path: `service.py` (HttpService on runtime/http_server.py,
ModelManager, ModelWatcher), `pipeline.py` (migration, detokenization,
stop strings), `preprocessor.py` (chat templates on jinja2),
`parsers.py`, `request_trace.py`, `affinity.py` (session headers) and
`tokenizer.py`, which the worker's guided decoding also uses.  Run it
with `python -m dynamo_tpu_torch.frontend`.  The modules are imported
where they are used, so a worker that needs only the tokenizer loads
no HTTP code."""
