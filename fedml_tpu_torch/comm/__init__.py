"""The host-edge wire of the cross-silo federation: the binary message
codec, the transport SPI, the in-process hub and the actor layer (the
port's copies of ``fedml_tpu/comm/{message,transport,local,actors}.py``).
gRPC, MQTT, chaos and resilient transports are not ported yet."""
