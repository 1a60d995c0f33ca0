"""Property-matching engine: the data-flow contract of the framework.

Every component declares its inputs/outputs as named physical quantities with
dims and units; the framework extracts raw arrays from the state, converts
units, reorders dims — with a ``'*'`` wildcard that collapses all horizontal
dims into one column axis — calls the component's ``array_call``, and re-wraps
outputs into labeled DataArrays.  This mirrors the behavior of the reference's
sympl property system (see /root/reference/docs/interaction.rst and dims like
``['mid_levels', '*']`` in every component, e.g.
/root/reference/climt/_components/rrtmg/lw/component.py:36-125; invariance
under transposed/reversed states is tested at
/root/reference/tests/test_components.py:216-250).

Design note: all matching logic here is *host-side metadata work*
resolved to transposes/reshapes/scales.  The compiled model path performs this
resolution once at build time; per-step code exchanges raw arrays directly.
"""

from __future__ import annotations

import numpy as np

from .dataarray import DataArray
from .units import conversion_factor, units_are_same


class InvalidStateError(Exception):
    pass


class InvalidPropertyDictError(Exception):
    pass


class ComponentMissingOutputError(Exception):
    pass


def _xp_for(values):
    if isinstance(values, np.ndarray) or np.isscalar(values):
        return np
    import jax.numpy as jnp
    return jnp


def explicit_dims_of(property_dict):
    """All non-wildcard dims mentioned in a property dict."""
    dims = set()
    for props in property_dict.values():
        for d in props.get('dims', []):
            if d != '*':
                dims.add(d)
    return dims


class WildcardInfo:
    """Canonical wildcard-dimension layout shared by all quantities in a call.

    ``dims``: the ordered tuple of dim names folded into the '*' axis.
    ``shape``: their sizes.  Order is sorted by name so that transposed or
    reversed input states produce identical flattened layouts.
    """

    __slots__ = ('dims', 'shape')

    def __init__(self, dims, shape):
        self.dims = tuple(dims)
        self.shape = tuple(shape)

    @property
    def size(self):
        size = 1
        for s in self.shape:
            size *= s
        return size


def compute_wildcard_info(state, property_dict):
    """Determine the wildcard dims/shape for a (state, properties) pair."""
    explicit = explicit_dims_of(property_dict)
    sizes = {}
    for name, props in property_dict.items():
        if name not in state:
            continue
        value = state[name]
        if not isinstance(value, DataArray):
            continue
        if '*' not in props.get('dims', []):
            continue
        for d, s in zip(value.dims, value.shape):
            if d in explicit:
                continue
            if d in sizes and sizes[d] not in (1, s) and s != 1:
                raise InvalidStateError(
                    'Dimension {!r} has conflicting sizes {} and {}'.format(
                        d, sizes[d], s))
            sizes[d] = max(sizes.get(d, 1), s)
    dims = sorted(sizes)
    return WildcardInfo(dims, [sizes[d] for d in dims])


def extract_arrays(state, property_dict, wildcard=None):
    """Return ({raw_name: raw_array}, WildcardInfo).

    Each raw array is transposed/reshaped so its axes follow the property's
    ``dims`` entry, with '*' flattened to the canonical wildcard axis, and its
    values converted to the property's units.
    """
    if wildcard is None:
        wildcard = compute_wildcard_info(state, property_dict)
    raw_state = {}
    if 'time' in state:
        raw_state['time'] = state['time']
    for name, props in property_dict.items():
        if name not in state:
            raise InvalidStateError(
                'Missing input quantity {!r}'.format(name))
        value = state[name]
        if not isinstance(value, DataArray):
            raw_state[props.get('alias', name)] = value
            continue
        target_dims = list(props.get('dims', list(value.dims)))
        raw = _to_raw(value, target_dims, props.get('units', value.units),
                      wildcard, name)
        raw_state[props.get('alias', name)] = raw
    return raw_state, wildcard


def _to_raw(value, target_dims, target_units, wildcard, name):
    # unit conversion first (cheap scalar multiply, fused later by XLA)
    arr = value.values
    if not units_are_same(value.units, target_units):
        scale, shift = conversion_factor(value.units, target_units)
        arr = arr * scale
        if shift != 0.0:
            arr = arr + shift

    src_dims = list(value.dims)
    xp = _xp_for(arr)

    # Build the transpose order: explicit dims by name, '*' -> wildcard dims.
    order = []
    out_is_wild = []
    for d in target_dims:
        if d == '*':
            for wd in wildcard.dims:
                order.append(wd)
            out_is_wild.append(True)
        else:
            order.append(d)
            out_is_wild.append(False)

    extra = [d for d in src_dims
             if d not in order and d not in wildcard.dims]
    # dims present in the array but not requested anywhere: only size-1 axes
    # may be dropped silently
    for d in extra:
        i = src_dims.index(d)
        if value.shape[i] != 1:
            raise InvalidStateError(
                'Quantity {!r} has dim {!r} not accepted by component '
                'dims {}'.format(name, d, target_dims))

    # insert broadcast axes for dims the array lacks
    shape_of = dict(zip(src_dims, value.shape))
    axes = []
    n_new = 0
    arr_dims = list(src_dims)
    for d in order:
        if d not in arr_dims:
            arr = arr[..., None] if hasattr(arr, 'ndim') else np.asarray(
                arr)[..., None]
            arr_dims.append(d)
            n_new += 1
    # squeeze unrequested size-1 dims
    for d in extra:
        i = arr_dims.index(d)
        arr = xp.squeeze(arr, axis=i)
        arr_dims.pop(i)
    axes = [arr_dims.index(d) for d in order]
    if axes != list(range(len(axes))):
        arr = xp.transpose(arr, axes)

    # broadcast wildcard axes to full size, then flatten them
    full_shape = []
    j = 0
    for d in order:
        if d in wildcard.dims:
            full_shape.append(wildcard.shape[wildcard.dims.index(d)])
        else:
            full_shape.append(shape_of.get(d, 1))
    if tuple(full_shape) != tuple(arr.shape):
        arr = xp.broadcast_to(arr, full_shape)

    # flatten wildcard dims into one axis, following target_dims structure
    final_shape = []
    j = 0
    for d, is_wild in zip(target_dims, out_is_wild):
        if is_wild:
            final_shape.append(wildcard.size)
            j += len(wildcard.dims)
        else:
            final_shape.append(full_shape[j])
            j += 1
    arr = xp.reshape(arr, final_shape)
    return arr


def restore_arrays(raw_arrays, property_dict, wildcard,
                   input_properties=None, dtype=None):
    """Wrap raw output arrays back into DataArrays.

    ``property_dict`` maps quantity names to output specs whose 'dims' may
    contain '*'; the wildcard axis is unflattened back to the recorded dims.
    Raw keys are aliases when defined (falling back to aliases declared in
    ``input_properties``, as the reference framework does).
    """
    alias_of = {}
    dims_of = {}
    if input_properties:
        for name, props in input_properties.items():
            if 'alias' in props:
                alias_of[name] = props['alias']
            if 'dims' in props:
                dims_of[name] = props['dims']
    out = {}
    for name, props in property_dict.items():
        raw_name = props.get('alias', alias_of.get(name, name))
        if raw_name not in raw_arrays:
            raise ComponentMissingOutputError(
                'Component did not compute output {!r} (raw name {!r})'.format(
                    name, raw_name))
        arr = raw_arrays[raw_name]
        target_dims = props.get('dims', dims_of.get(name))
        if target_dims is None:
            raise InvalidPropertyDictError(
                'No dims known for output {!r}'.format(name))
        out_dims = []
        out_shape = []
        j = 0
        for d in target_dims:
            if d == '*':
                out_dims.extend(wildcard.dims)
                out_shape.extend(wildcard.shape)
            else:
                out_dims.append(d)
                out_shape.append(arr.shape[j] if hasattr(arr, 'shape')
                                 else 1)
            j += 1
        xp = _xp_for(arr)
        arr = xp.reshape(arr, out_shape)
        out[name] = DataArray(
            arr, tuple(out_dims), {'units': props.get('units', '')}, name)
    return out


def combine_component_properties(components, property_name, input_state=None):
    """Aggregate a property dict over components (union, units checked).

    Mirrors the contract of the reference's
    ``sympl.combine_component_properties`` used by ``get_default_state``
    (/root/reference/climt/_core/initialization.py:762-768).
    """
    combined = {}
    for component in components:
        props = getattr(component, property_name, {})
        for name, spec in props.items():
            if name not in combined:
                combined[name] = dict(spec)
            else:
                if not units_are_same(
                        combined[name].get('units', ''),
                        spec.get('units', '')):
                    # keep the first; callers convert per-component anyway
                    pass
    return combined
