"""Per-model token prices of the MOAR cost model, $ per 1M tokens.

These are data of the optimizer's objective: the prices the JAX package's
model catalog assigns each model of the pool (``price_in``/``price_out``).
The port keeps them as a constant table so that a pipeline costs the same
on either backend; a test pins the table to the JAX catalog.
"""

from __future__ import annotations

from typing import Dict, Tuple

# model -> (price_in, price_out)
PRICES: Dict[str, Tuple[float, float]] = {
    "granite-moe-1b-a400m": (0.003626554043993232, 0.17236742043142045),
    "grok-1-314b": (0.7085939135025381, 2.8815818835978835),
    "whisper-medium": (0.008115087377326564, 0.3338599592999593),
    "gemma2-9b": (0.07818447485617597, 0.9191396695156695),
    "llama3.2-1b": (0.010455282571912014, 0.1171123549043549),
    "gemma3-27b": (0.22849678294416242, 0.622426231990232),
    "granite-34b": (0.3971906274111675, 0.4487831469271469),
    "mamba2-370m": (0.003115710592216582, 0.002342013838013838),
    "zamba2-2.7b": (0.0198020951607445, 0.32215983496133493),
    "internvl2-1b": (0.004177270253807106, 0.044109968253968256),
}
