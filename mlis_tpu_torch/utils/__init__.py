"""Host-side helpers: analytic FLOP and byte counts, the H100 roofline, profiling."""
