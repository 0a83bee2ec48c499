"""The card's published peaks: NVIDIA H100 SXM data sheet, dense, at its
700 W power limit (a card set below it runs slower under load; every
run prints the card's name beside its numbers)."""
BYTES_PER_S = 3.35e12      # HBM3 bandwidth
F32_PER_S = 67e12          # float32 outside the tensor cores
