"""The exchange, halo and migrate engines, and the rank mesh, its
collectives and the world launcher for running one rank a process."""
