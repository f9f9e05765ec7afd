"""The module-scaling core of the port: plan, cluster, monitor, the
scale-up / scale-down algorithms, the controller and the migration cost
model. Copies of ``repro.core`` with their imports pointing at
``repro_torch``; ``migration`` and ``replication`` keep only what one card
runs."""
