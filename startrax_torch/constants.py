"""Numerical constants shared across the port (same values as startrax.constants)."""

# float32 machine epsilon: clamp floor for probabilities and entropies.
EPS = 1.1920928955078125e-07

# Additive guard inside the transmittance cumprod.
TRANS_EPS = 1e-10

# Guard for disparity maps.
DISP_EPS = 1e-10

# Additive guard on PDF weights before normalisation.
PDF_EPS = 1e-5
