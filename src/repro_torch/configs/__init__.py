"""Application configurations of the port (SockShop, paper §6.3)."""
