"""Distribution layer (port of ``vrt.dist``): process groups and meshes,
ray data parallelism, and slab-sharded (model-parallel) volumes with halo
exchange, over ``torch.distributed``.

- ``vrt_torch.dist.mesh``: ``torch.distributed`` bring-up, the
  ('data', 'model') ``DeviceMesh``, and the three collectives the layer
  uses (all-gather, sum all-reduce, the neighbour send/recv pair),
- ``vrt_torch.dist.sharding``: the ray-sharded frame
  (``render_image_sharded``),
- ``vrt_torch.dist.brick``: a volume split into x-slabs with 2-voxel halos,
  the slab march (K7 on the card, ``march_volume_slab``), the closest-hit
  combine, the halo refresh, the slab resolve,
- ``vrt_torch.dist.slab_render``: the render pipeline over a slab-sharded
  volume (``SlabTracer``, ``GatherSlabTracer``, ``render_slab_image``).

Where ``vrt`` runs one SPMD program under ``shard_map``, the port runs one
process per rank; each holds its own slab and ray slice.  The fit steps
(``make_fit_step_dp``, ``make_slab_fit_step``) are not ported yet.
"""
