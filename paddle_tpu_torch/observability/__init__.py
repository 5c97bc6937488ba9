"""The part of paddle_tpu/observability that the port needs so far:
`requests.safe_request_id`, the header echo-safety check that tenant
ids share. The registry, the request tracing and the metrics catalogue
come with the serving surface."""
