-- Shared helpers for Lua auth scripts (vernemq_tpu_torch edition).
--
-- Loaded via require "auth/auth_commons". Provides the helper API that
-- datastore auth scripts build on: cache_insert (validated handoff to
-- the broker's ACL cache), type_assert / validate_acls (argument
-- checking), and conservative default hook implementations — publish
-- and subscribe auth answer false until a successful auth_on_register
-- has populated the cache, because the ACL cache front-ends those
-- hooks inside the broker. Implemented for this project against the
-- documented script surface (table-driven validation; not derived from
-- any reference distribution file).

-- known ACL field -> required type; anything else takes a scalar
local acl_field_rules = {
    pattern   = "string",
    modifiers = "table",
}

function type_assert(value, expected, what)
    local got = type(value)
    if type(expected) ~= "table" then
        expected = { expected }
    end
    for _, want in ipairs(expected) do
        if got == want then
            return value
        end
    end
    error(what .. ": wanted " .. table.concat(expected, "/")
          .. ", got " .. got)
end

function validate_acls(acls)
    if acls == nil then
        return
    end
    type_assert(acls, "table", "acl list")
    for _, entry in ipairs(acls) do
        type_assert(entry, "table", "acl entry")
        for key, v in pairs(entry) do
            type_assert(key, "string", "acl field name")
            type_assert(v, acl_field_rules[key]
                        or { "string", "number", "boolean" },
                        "acl " .. key)
        end
    end
end

function cache_insert(mountpoint, client_id, username, publish_acl,
                      subscribe_acl)
    type_assert(mountpoint, "string", "mountpoint")
    type_assert(client_id, "string", "client_id")
    type_assert(username, "string", "username")
    type_assert(publish_acl, { "table", "nil" }, "publish_acl")
    type_assert(subscribe_acl, { "table", "nil" }, "subscribe_acl")
    validate_acls(publish_acl)
    validate_acls(subscribe_acl)
    auth_cache.insert(mountpoint, client_id, username,
                      publish_acl, subscribe_acl)
end

-- Default hook bodies. Deny-by-default: traffic is authorized by the
-- broker-side ACL cache populated from auth_on_register, so a script
-- that reaches these without a cache hit should refuse. The *_m5
-- variants delegate to the v4 implementations the script defines.

local function deny(_)
    return false
end

local function noop(_)
end

auth_on_publish = deny
auth_on_publish_m5 = deny
auth_on_subscribe = deny
auth_on_subscribe_m5 = deny
on_unsubscribe = noop
on_client_gone = noop
on_client_offline = noop

function auth_on_register_m5(reg)
    return auth_on_register(reg)
end
