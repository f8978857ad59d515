"""Host-side helpers: analytic FLOP counts."""
