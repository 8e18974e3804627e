"""How each cell's calls drive the port and are judged; one module an entry."""
