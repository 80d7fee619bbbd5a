"""Host-side EHYB build (numpy), device containers, plain applies and CG."""
