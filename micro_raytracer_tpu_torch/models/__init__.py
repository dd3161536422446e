"""Scene schema, compiler, camera, tracer and renderer."""
